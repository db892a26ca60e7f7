"""launch_host_ms.sample: host time a sampler call inside the program's
``launch.*`` spans: the calls of its hand-written kernels' C entry points,
in milliseconds."""
from portbench.port_spans import per_unit


def read(trace: dict):
    return per_unit(trace, "launch.", "total_s", 1e3, prefix=True)
