"""lfae_device_ms.sample: device time a sampler call of the LFAE's encode
(with the reference features) and decode, in milliseconds."""

LAYERS = ("layer.encode", "layer.decode")


def read(trace: dict):
    device_s = sum(trace["spans"].get(n, (0.0, 0))[0] for n in LAYERS)
    if trace["units"] == 0 or device_s <= 0:
        return None  # the layers did not run, or ran on no device
    return 1e3 * device_s / trace["units"]
