"""Random thin-plate-spline transform for the equivariance losses (port of
extdm_tpu/models/lfae/transform.py).

The transform is a tuple of sampled parameters; ``warp_coordinates``,
``transform_frame`` and ``jacobian`` are plain functions of it. The JAX
package takes the jacobian with two ``jax.jvp`` passes; here it is the
closed-form derivative of the TPS map, built from differentiable ops, since
the equivariance-affine loss backpropagates through it into the region
shifts.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from extdm_tpu_torch.ops.coords import make_coordinate_grid
from extdm_tpu_torch.ops.fused_warp import grid_sample

_RBF_EPS = 1e-6


class TPSTransform(NamedTuple):
    theta: torch.Tensor  # (B, 2, 3) affine
    control_points: Optional[torch.Tensor]  # (P*P, 2)
    control_params: Optional[torch.Tensor]  # (B, 1, P*P)


def random_tps(generator: Optional[torch.Generator], batch: int, sigma_affine: float,
               sigma_tps: Optional[float] = None, points_tps: Optional[int] = None,
               device=None) -> TPSTransform:
    """theta = eye(2, 3) + N(0, sigma_affine); with sigma_tps and points_tps,
    a points_tps x points_tps control grid with N(0, sigma_tps) weights. The
    draws come from `generator` (on `device`)."""
    noise = torch.randn((batch, 2, 3), generator=generator, device=device) * sigma_affine
    theta = noise + torch.eye(2, 3, device=device)[None]
    if sigma_tps is not None and points_tps is not None:
        cp = make_coordinate_grid(points_tps, points_tps, device=device).reshape(-1, 2)
        params = torch.randn((batch, 1, points_tps ** 2), generator=generator,
                             device=device) * sigma_tps
        return TPSTransform(theta, cp, params)
    return TPSTransform(theta, None, None)


def warp_coordinates(t: TPSTransform, coords: torch.Tensor) -> torch.Tensor:
    """coords (B, N, 2) -> (B, N, 2)."""
    theta = t.theta.to(coords.dtype)
    out = torch.einsum("bij,bnj->bni", theta[:, :, :2], coords) + theta[:, None, :, 2]
    if t.control_points is not None:
        cp = t.control_points.to(coords.dtype)
        dist = (coords[:, :, None, :] - cp[None, None]).abs().sum(-1)  # (B, N, P2), L1
        rbf = dist ** 2 * torch.log(dist + _RBF_EPS)
        out = out + (rbf * t.control_params.to(coords.dtype)).sum(-1, keepdim=True)
    return out


def transform_frame(t: TPSTransform, frame: torch.Tensor) -> torch.Tensor:
    """frame (B, H, W, C) sampled at the TPS-warped identity grid, reflection padding."""
    B, H, W, _ = frame.shape
    grid = make_coordinate_grid(H, W, frame.dtype, frame.device).reshape(1, H * W, 2)
    warped = warp_coordinates(t, grid.expand(B, H * W, 2)).reshape(B, H, W, 2)
    return grid_sample(frame, warped, padding_mode="reflection")


def jacobian(t: TPSTransform, coords: torch.Tensor) -> torch.Tensor:
    """d warp / d coords at each point, (B, N, 2, 2): rows are the output
    components, columns the input derivatives. Differentiable in coords."""
    theta = t.theta.to(coords.dtype)
    jac = theta[:, None, :, :2].expand(coords.shape[0], coords.shape[1], 2, 2)
    if t.control_points is None:
        return jac
    cp = t.control_points.to(coords.dtype)
    diff = coords[:, :, None, :] - cp[None, None]  # (B, N, P2, 2)
    dist = diff.abs().sum(-1)
    # d|u|/du taken as +1 at u = 0, as jax.jvp of jnp.abs does
    sign = torch.where(diff >= 0, 1.0, -1.0).to(coords.dtype)
    drbf = 2 * dist * torch.log(dist + _RBF_EPS) + dist ** 2 / (dist + _RBF_EPS)
    dres = ((drbf * t.control_params.to(coords.dtype))[..., None] * sign).sum(2)  # (B, N, 2)
    # the spline term is added to both output components
    return jac + dres[:, :, None, :]
