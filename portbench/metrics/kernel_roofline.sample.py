"""kernel_roofline.sample: the least time of the kernel entry points' calls
in the window (portbench/cost/kernels.py, from their shapes) over those
calls' device time: the union of the trace's device records between each
call's markers (portbench/trace.py), whatever kernels the call launched."""
from portbench.cost.kernels import share

KINDS = ("stw_layer", "temporal_layer", "resnet_block", "grid_sample")


def read(trace: dict):
    bound = sum(trace["bounds"].get(k, 0.0) for k in KINDS)
    device = sum(trace["spans"].get(f"op.{k}", (0.0, 0))[0] for k in KINDS)
    return share(bound, device)
