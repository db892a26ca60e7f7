"""Coordinate-grid helpers for flow warping (port of extdm_tpu/ops/coords.py)."""
from __future__ import annotations

import numpy as np
import torch


def make_coordinate_grid(h: int, w: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(h, w, 2) grid of (x, y) in [-1, 1]; channel 0 varies along width."""
    x = np.linspace(-1.0, 1.0, w) if w > 1 else np.zeros((1,))
    y = np.linspace(-1.0, 1.0, h) if h > 1 else np.zeros((1,))
    xx, yy = np.meshgrid(x, y)
    return torch.as_tensor(np.stack([xx, yy], axis=-1), dtype=dtype, device=device)


def region2gaussian(center: torch.Tensor, covar, spatial_size) -> torch.Tensor:
    """Gaussian heatmaps (..., h, w) for centers (..., 2) and either a scalar
    variance or (..., 2, 2) covariances."""
    h, w = spatial_size
    grid = make_coordinate_grid(h, w, center.dtype, center.device)
    lead = center.shape[:-1]
    grid = grid.reshape((1,) * len(lead) + (h, w, 2))
    diff = grid - center.reshape(lead + (1, 1, 2))
    if isinstance(covar, (float, int)):
        return torch.exp(-0.5 * (diff ** 2).sum(-1) / covar)
    covar_inv = torch.linalg.inv(covar).reshape(lead + (1, 1, 2, 2))
    tmp = torch.einsum("...i,...ij->...j", diff, covar_inv)
    return torch.exp(-0.5 * (tmp * diff).sum(-1))


def to_homogeneous(coords: torch.Tensor) -> torch.Tensor:
    return torch.cat([coords, torch.ones_like(coords[..., :1])], dim=-1)


def from_homogeneous(coords: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return coords[..., :2] / (coords[..., 2:3] + eps)
