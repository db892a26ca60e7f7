"""lfae_device_ms.train: device time a train step of the frozen LFAE's
encode of the clips and of their reference features, in milliseconds."""

LAYERS = ("layer.encode_video", "layer.ref_features")


def read(trace: dict):
    device_s = sum(trace["spans"].get(n, (0.0, 0))[0] for n in LAYERS)
    if trace["units"] == 0 or device_s <= 0:
        return None  # the layers did not run, or ran on no device
    return 1e3 * device_s / trace["units"]
