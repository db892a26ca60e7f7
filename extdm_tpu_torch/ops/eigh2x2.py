"""Closed-form symmetric 2x2 eigendecomposition (port of extdm_tpu/ops/eigh2x2.py).

Kept in closed form: torch.linalg.eigh orders and signs eigenvectors
differently, and the region affines depend on this exact choice.
"""
from __future__ import annotations

import torch


def eigh_2x2(covar: torch.Tensor, eps: float = 1e-12):
    """(u, s) of symmetric (..., 2, 2) matrices: eigenvector columns u and
    eigenvalues s in descending order."""
    a = covar[..., 0, 0]
    b = 0.5 * (covar[..., 0, 1] + covar[..., 1, 0])
    c = covar[..., 1, 1]
    tr_half = 0.5 * (a + c)
    det_term = torch.sqrt(torch.clamp(0.25 * (a - c) ** 2 + b * b, min=0.0) + eps)
    lam1 = tr_half + det_term
    lam2 = tr_half - det_term
    # of the two equivalent eigenvector forms, take the one without cancellation
    use_first = a < c
    v1x = torch.where(use_first, b, lam1 - c)
    v1y = torch.where(use_first, lam1 - a, b)
    norm_sq = v1x * v1x + v1y * v1y
    degenerate = norm_sq < eps
    v1x = torch.where(degenerate, torch.ones_like(v1x), v1x)
    v1y = torch.where(degenerate, torch.zeros_like(v1y), v1y)
    norm = torch.sqrt(torch.where(degenerate, torch.ones_like(norm_sq), norm_sq) + eps)
    v1x, v1y = v1x / norm, v1y / norm
    v2x, v2y = -v1y, v1x
    u = torch.stack([torch.stack([v1x, v2x], -1), torch.stack([v1y, v2y], -1)], -2)
    return u, torch.stack([lam1, lam2], -1)


def sqrt_symmetric_2x2(covar: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """U diag(sqrt(max(S, 0))) for symmetric PSD (..., 2, 2) matrices."""
    u, s = eigh_2x2(covar, eps=eps)
    return u * torch.sqrt(torch.clamp(s, min=0.0) + eps)[..., None, :]


def inv_2x2(m: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Batched closed-form 2x2 inverse."""
    a, b = m[..., 0, 0], m[..., 0, 1]
    c, d = m[..., 1, 0], m[..., 1, 1]
    det = a * d - b * c
    det = torch.where(det.abs() < eps, torch.sign(det) * eps + (det == 0) * eps, det)
    inv = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2)
    return inv / det[..., None, None]
