"""unet_host_ms.sample: host time a sampler call inside the program's
``unet.forward`` spans: issuing the UNet for the conditioning term and every
DDIM step, in milliseconds (beside ``unet_device_ms.sample``, the card's
time for the same work)."""
from portbench.port_spans import per_unit


def read(trace: dict):
    return per_unit(trace, "unet.forward", "total_s", 1e3)
