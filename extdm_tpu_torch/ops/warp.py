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


def grid_sample_dgrid_plain(g: torch.Tensor, image: torch.Tensor, grid: torch.Tensor,
                            padding_mode: str = "zeros") -> torch.Tensor:
    """d_grid of ``grid_sample_plain`` for the cotangent g (B, Ho, Wo, C), in
    closed form with the rules of the TPU kernel (extdm_tpu/ops/pallas_warp.py
    ``_make_bwd_kernel``) and of the backward kernel that replaces it: the
    border clamp passes the gradient strictly inside (0, size - 1), the
    reflection's derivative is -1 on the fold itself, and a corner out of
    range reads 0 in every mode. Off the clamp and fold lines this is
    autograd's d_grid of ``grid_sample_plain``; on them autograd differs (a
    border bound, a fold). float32 (B, Ho, Wo, 2)."""
    if padding_mode not in PADDING_MODES:
        raise ValueError(f"unknown padding_mode: {padding_mode}")
    B, H, W, C = image.shape
    _, Ho, Wo, _ = grid.shape

    def fold(v, size):  # (folded coordinate, its derivative)
        if padding_mode == "border":
            return v.clamp(0.0, size - 1), ((v > 0) & (v < size - 1)).float()
        if padding_mode == "reflection":
            if size == 1:
                return torch.zeros_like(v), torch.zeros_like(v)
            span = 2.0 * (size - 1)
            r = torch.remainder(v, span)
            return torch.minimum(r, span - r), torch.where(r < span - r, 1.0, -1.0)
        return v, torch.ones_like(v)

    x, dcx = fold((grid[..., 0].float() + 1.0) * 0.5 * (W - 1), W)
    y, dcy = fold((grid[..., 1].float() + 1.0) * 0.5 * (H - 1), H)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]
    flat = image.reshape(B, H * W, C)

    def corner(xi, yi):
        valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        xc = xi.nan_to_num(0.0).clamp(0, W - 1).long()
        yc = yi.nan_to_num(0.0).clamp(0, H - 1).long()
        idx = (yc * W + xc).reshape(B, Ho * Wo, 1).expand(B, Ho * Wo, C)
        vals = torch.gather(flat, 1, idx).reshape(B, Ho, Wo, C).float()
        return torch.where(valid[..., None], vals, 0.0)

    v0, v1 = corner(x0, y0), corner(x0 + 1, y0)
    v2, v3 = corner(x0, y0 + 1), corner(x0 + 1, y0 + 1)
    go = g.float()
    gx = (go * ((1 - wy) * (v1 - v0) + wy * (v3 - v2))).sum(-1)
    gy = (go * ((1 - wx) * (v2 - v0) + wx * (v3 - v1))).sum(-1)
    return torch.stack([gx * dcx * (0.5 * (W - 1)), gy * dcy * (0.5 * (H - 1))], -1)
