"""Seeding, logging, the flow pictures, the pictures of the jobs and tools
(``utils.visualize``) and the JAX checkpoint reader (``utils.msgpack``)."""
from extdm_tpu_torch.utils.flow_viz import conf2fig, flow2fig, flow_to_color, grid_to_flow
from extdm_tpu_torch.utils.logger import AverageMeter, Logger, MetricLogger, StepTimer
from extdm_tpu_torch.utils.seed import setup_seed

__all__ = ["conf2fig", "flow2fig", "flow_to_color", "grid_to_flow", "AverageMeter", "Logger",
           "MetricLogger", "StepTimer", "setup_seed"]
