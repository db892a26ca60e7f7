"""forward_host_ms.train: host time a train step inside the program's
``train.forward`` span: the LFAE encode, the noising and the UNet forward
with the loss, in milliseconds."""
from portbench.port_spans import per_unit


def read(trace: dict):
    return per_unit(trace, "train.forward", "total_s", 1e3)
