"""Bilinear grid sample, plain PyTorch (port of extdm_tpu/ops/warp.py).

Matches ``torch.nn.functional.grid_sample(align_corners=True)`` with
``padding_mode`` in {"zeros", "border", "reflection"} on channels-last
tensors: a four-corner gather in the image's dtype and a lerp in float32.
This is the plain version of the ``grid_sample`` kernel in ``fused_warp``.
"""
from __future__ import annotations

import torch

PADDING_MODES = ("zeros", "border", "reflection")


def reflect_coords(x: torch.Tensor, size: int) -> torch.Tensor:
    """Reflect pixel coords into [0, size-1] with period 2*(size-1)."""
    if size == 1:
        return torch.zeros_like(x)
    span = 2.0 * (size - 1)
    x = torch.remainder(x, span)
    return torch.minimum(x, span - x)


def grid_sample_plain(image: torch.Tensor, grid: torch.Tensor,
                      padding_mode: str = "zeros") -> torch.Tensor:
    """image (B, H, W, C), grid (B, Ho, Wo, 2) of (x, y) in [-1, 1] -> (B, Ho, Wo, C)."""
    if padding_mode not in PADDING_MODES:
        raise ValueError(f"unknown padding_mode: {padding_mode}")
    B, H, W, C = image.shape
    _, Ho, Wo, _ = grid.shape
    gx = grid[..., 0].float()
    gy = grid[..., 1].float()
    x = (gx + 1.0) * 0.5 * (W - 1)
    y = (gy + 1.0) * 0.5 * (H - 1)
    if padding_mode == "reflection":
        x, y = reflect_coords(x, W), reflect_coords(y, H)
    elif padding_mode == "border":
        x, y = x.clamp(0.0, W - 1), y.clamp(0.0, H - 1)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]
    flat = image.reshape(B, H * W, C)

    def corner(xi, yi):
        # a NaN coordinate (a non-finite step, which the nan guard skips)
        # reads pixel 0 and gives a NaN output through its weight
        xc = xi.nan_to_num(0.0).clamp(0, W - 1).long()
        yc = yi.nan_to_num(0.0).clamp(0, H - 1).long()
        idx = (yc * W + xc).reshape(B, Ho * Wo, 1).expand(B, Ho * Wo, C)
        vals = torch.gather(flat, 1, idx).reshape(B, Ho, Wo, C).float()
        if padding_mode == "zeros":
            valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
            vals = vals * valid[..., None].float()
        return vals

    top = corner(x0, y0) * (1 - wx) + corner(x0 + 1, y0) * wx
    bot = corner(x0, y0 + 1) * (1 - wx) + corner(x0 + 1, y0 + 1) * wx
    return (top * (1 - wy) + bot * wy).to(image.dtype)
