"""backward_host_ms.train: host time a train step inside the program's
``train.backward`` span (``loss.backward()``: issuing the backward and
waiting for autograd's device thread to issue its kernels), in milliseconds."""
from portbench.port_spans import per_unit


def read(trace: dict):
    return per_unit(trace, "train.backward", "total_s", 1e3)
