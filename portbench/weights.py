"""Weights and inputs made from the run's seed, on the device, in a few
large draws.

``state_dict(model, seed, device)`` gives every tensor of the reference's
state dict (the keys the reference checkpoints use, which the program
loads as they are) from one normal draw of a ``torch.Generator`` on the
device, scaled per tensor: He-scaled weights, norm scales near 1, small
biases, unit running variances. Three groups get their own scale so that
random weights give sane motion and noise (``GAINS``), and the background
predictor's head starts near the identity transform, as the trained
model's does.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference.pipeline import Reference

SEED_MASK = (1 << 63) - 1
# Gains other than He's: the region logits (divided by a temperature of 0.1)
# small enough for soft heatmaps, and the denoiser's two output projections
# small enough that the predicted noise is near unit size (He's gain gives
# ~40 at the KTH widths).
GAINS = {"lfae.region_predictor.regions.weight": 0.2,
         "unet.final_conv.1.weight": 0.05, "unet.occlusion_map.1.weight": 0.05}


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for one use (`stream`) of the run's seed."""
    return torch.Generator(device=device).manual_seed((seed * 1_000_003 + stream) & SEED_MASK)


def _scale(key: str, shape) -> tuple:
    """(mean, std) of the tensor at `key`."""
    numel = math.prod(shape)
    if key.endswith("running_mean"):
        return 0.0, 0.1
    if key.endswith("running_var"):
        return 1.0, 0.0
    if "relative_position_bias_table" in key or "relative_attention_bias" in key:
        return 0.0, 0.02
    if key.startswith("lfae.bg_predictor.fc."):
        return 0.0, 1e-3
    if key.endswith("gamma") or (len(shape) == 1 and key.endswith("weight")):
        return 1.0, 0.1  # a norm's scale (every 1-d weight is one)
    if len(shape) >= 2:
        return 0.0, GAINS.get(key, math.sqrt(2.0)) / math.sqrt(numel // shape[0])
    return 0.0, 0.05


def state_dict(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seeded float32 weights of configuration `model` under the
    reference's keys (``lfae.*``, ``unet.*``), on `device`."""
    with torch.device("meta"):
        shapes = {k: (tuple(v.shape), v.dtype) for k, v in Reference(model).state_dict().items()}
    floats = {k: s for k, (s, dt) in shapes.items() if dt.is_floating_point}
    total = sum(math.prod(s) for s in floats.values())
    flat = torch.randn(total, generator=generator(seed, 0, device), device=device)
    out, at = {}, 0
    for key, shape in floats.items():
        n = math.prod(shape)
        mean, std = _scale(key, shape)
        out[key] = flat[at:at + n].view(shape).mul_(std).add_(mean)
        at += n
    for key, (shape, dt) in shapes.items():
        if key not in out:  # num_batches_tracked
            out[key] = torch.zeros(shape, dtype=dt, device=device)
    bias = out.get("lfae.bg_predictor.fc.bias")
    if bias is not None:  # the identity transform (and no perspective)
        bias[:6] += torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0], device=device)
    return out


def reference(model: dict, seed: int, device) -> Reference:
    """The plain reference of configuration `model` with the seed's weights."""
    ref = Reference(model).to(device)
    ref.load_state_dict(state_dict(model, seed, device))
    return ref.eval()


def split(sd: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """The entries under `prefix` (``"lfae."`` or ``"unet."``), prefix removed."""
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def clips(seed: int, stream: int, n: int, frames: int, size: int, device) -> torch.Tensor:
    """n smooth random clips (n, frames, size, size, 3) in [0, 1]: colour
    fields at 1/8 of the size, moving linearly from one field to another
    over the clip, upsampled bilinearly."""
    g = generator(seed, stream, device)
    lo = max(2, size // 8)
    a, b = torch.rand((2, n, 3, lo, lo), generator=g, device=device)
    w = torch.linspace(0.0, 1.0, frames, device=device).reshape(1, frames, 1, 1, 1)
    fields = (a[:, None] * (1 - w) + b[:, None] * w).reshape(n * frames, 3, lo, lo)
    video = torch.nn.functional.interpolate(fields, size=(size, size), mode="bilinear",
                                            align_corners=False)
    return video.reshape(n, frames, 3, size, size).permute(0, 1, 3, 4, 2).contiguous()
