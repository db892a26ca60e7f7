"""Model flops of a sampler call and of a DM train step, counted by
``torch.utils.flop_counter.FlopCounterMode`` over the benchmark's plain
reference on the ``meta`` device: convolutions, matrix products and the
attention products, at the cell's shapes, with no arithmetic done. The
count depends on the configuration alone, so a program change that fuses,
splits or removes work moves the time and not the count. Every count is
linear in the rows (no row reads another), so one row is counted and
multiplied, and the denoiser, whose DDIM steps all have one shape, is
counted once and multiplied by the steps.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference.pipeline import Reference


def _latent_size(model: dict) -> int:
    pf = model["flow_params"]["generator_params"]["pixelwise_flow_predictor_params"]
    return int(model["frame_shape"] * pf["scale_factor"])


def sample_flops(model: dict, rows: int) -> float:
    """Flops of one sampler call of `rows` rows: the LFAE encode of the cond
    frames and their reference features, the conditioning term, every DDIM
    step of the denoiser and the decode of the predicted frames."""
    tc, tp, px, h = model["cond_frames"], model["pred_frames"], model["frame_shape"], \
        _latent_size(model)
    with torch.device("meta"), torch.no_grad():
        ref = Reference(model)
        with FlopCounterMode(display=False) as once:
            x_cond, fea = ref.encode(torch.rand(1, tc, px, px, 3))
            cond = ref.unet.cond_term(fea, h, h)
            ref.lfae.decode_flows(torch.rand(1, px, px, 3), torch.rand(1, tp, h, h, 2),
                                  torch.rand(1, tp, h, h, 1))
        with FlopCounterMode(display=False) as step:
            ref.unet(torch.randn(1, tp, h, h, 3), torch.zeros(1, dtype=torch.long), x_cond,
                     cond_term=cond)
    steps = model["sampling_timesteps"]
    return float(once.get_total_flops() + steps * step.get_total_flops()) * rows


def train_flops(model: dict, batch: int) -> float:
    """Flops of one DM train step of `batch` clips: the frozen LFAE's encode
    (no gradient), the denoiser's forward and its backward (input and weight
    gradients); recompute for memory is not counted, nor the optimizer's
    elementwise update."""
    tc, tp, px, h = model["cond_frames"], model["pred_frames"], model["frame_shape"], \
        _latent_size(model)
    with torch.device("meta"):
        ref = Reference(model)
        with FlopCounterMode(display=False) as counter:
            loss = ref.loss(torch.rand(1, tc + tp, px, px, 3), torch.zeros(1, dtype=torch.long),
                            torch.randn(1, tp, h, h, 3))
            loss.backward()
    return float(counter.get_total_flops()) * batch
