"""mfu.sample: the sampler calls' model flops (portbench/cost/flops.py)
over the traced window, as a share of one H100's dense bf16 peak."""
import torch

from portbench.cost.kernels import PEAK_FLOPS


def read(trace: dict):
    if trace["units"] == 0 or trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None  # no device in the trace: a host run has no share of the card's peak
    flops = trace["unit_flops"] * trace["units"]
    return 100.0 * flops / trace["window_s"] / PEAK_FLOPS[torch.bfloat16]
