"""unet_device_ms.sample: device time a sampler call of the denoiser: the conditioning term
and every DDIM step, in milliseconds."""

LAYERS = ("layer.cond_cache", "layer.ddim")


def read(trace: dict):
    device_s = sum(trace["spans"].get(n, (0.0, 0))[0] for n in LAYERS)
    if trace["units"] == 0 or device_s <= 0:
        return None  # the layers did not run, or ran on no device
    return 1e3 * device_s / trace["units"]
