"""idle_share.sample: the share of the traced window in which no kernel,
copy or set ran on the card."""


def read(trace: dict):
    if trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
