"""Resizes with torch semantics, channels-last (port of extdm_tpu/ops/resize.py)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def interpolate_bilinear(x: torch.Tensor, size, align_corners: bool = False) -> torch.Tensor:
    """(..., H, W, C) -> (..., size[0], size[1], C), bilinear without antialias."""
    h, w = size
    *lead, H, W, C = x.shape
    if (H, W) == (h, w):
        return x
    flat = x.reshape(-1, H, W, C).permute(0, 3, 1, 2)
    out = F.interpolate(flat, size=(h, w), mode="bilinear", align_corners=align_corners)
    return out.permute(0, 2, 3, 1).reshape(*lead, h, w, C)


def upsample_nearest(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """(..., H, W, C) -> (..., H*scale, W*scale, C) by pixel duplication."""
    return x.repeat_interleave(scale, dim=-3).repeat_interleave(scale, dim=-2)


def avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool, stride 2, on (..., H, W, C)."""
    *lead, H, W, C = x.shape
    return x.reshape(*lead, H // 2, 2, W // 2, 2, C).mean(dim=(-4, -2))
