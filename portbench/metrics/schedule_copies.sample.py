"""schedule_copies.sample: copies a sampler call of a diffusion schedule table
from the host to the card (the program's ``schedule_copy`` spans)."""
from portbench.port_spans import per_unit


def read(trace: dict):
    return per_unit(trace, "schedule_copy", "calls")
