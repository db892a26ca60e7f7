"""optimizer_host_ms.train: host time a train step inside the program's
``train.optimizer`` span: the gradient norm, the nan guard and the scheduled
AdamW step, in milliseconds."""
from portbench.port_spans import per_unit


def read(trace: dict):
    return per_unit(trace, "train.optimizer", "total_s", 1e3)
