"""launch_host_ms.train: host time a train step inside the program's
``launch.*`` spans, on the calling thread and on autograd's device thread:
the calls of its hand-written kernels' C entry points, forward and backward,
in milliseconds."""
from portbench.port_spans import per_unit


def read(trace: dict):
    return per_unit(trace, "launch.", "total_s", 1e3, prefix=True)
