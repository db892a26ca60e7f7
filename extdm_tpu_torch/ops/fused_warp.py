"""Kernels 4 and 8: bilinear grid sample and its backward (``csrc/grid_sample.cu``).

Kernel 4 replaces ``extdm_tpu/ops/pallas_warp.py`` ``grid_sample`` (its
one-hot-matmul Pallas kernel, ``_make_kernel``). The H100 is bound by bytes
here: a direct four-corner gather with one thread per (output pixel, channel),
channel fastest, so all reads and writes coalesce for any channel count; the
JAX package's VMEM/tileability gate (``pallas_warp.supported``) has no
counterpart, and every warp of the path goes through the kernel.

Kernel 8 replaces ``pallas_warp.py`` ``_grid_sample_bwd_impl`` (its
``_make_bwd_kernel``): d_image scattered into the four corners with float32
atomics, d_grid summed over channels by a group of lanes per output pixel.
The JAX package takes its Pallas backward only for small images and few
channels (``_bwd_supported``); here every warp's backward takes the kernel.

``grid_sample`` runs the kernel for CUDA tensors and the plain version
(``grid_sample_plain``) for CPU tensors. On CUDA, when an operand needs a
gradient, it runs inside a ``torch.autograd.Function`` whose backward is
``grid_sample_bwd`` (kernel 8; its plain version ``grid_sample_plain_vjp`` is
the autograd of ``grid_sample_plain``). ``grid_sample.launches`` and
``grid_sample_bwd.launches`` count kernel launches.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from extdm_tpu_torch import _build
from extdm_tpu_torch.ops.fused_stw import _needs_grad, plain_vjp
from extdm_tpu_torch.ops.warp import PADDING_MODES, grid_sample_plain

__all__ = ["grid_sample", "grid_sample_plain", "grid_sample_bwd", "grid_sample_plain_vjp"]


def _check(what, image, grid, padding_mode):
    if not (image.is_cuda and grid.device == image.device):
        raise ValueError(f"{what}: image on {image.device}, grid on {grid.device}")
    if padding_mode not in PADDING_MODES:
        raise ValueError(f"unknown padding_mode: {padding_mode}")
    if image.ndim != 4 or grid.ndim != 4 or grid.shape[0] != image.shape[0] or grid.shape[-1] != 2:
        raise ValueError(f"{what}: image {tuple(image.shape)} vs grid {tuple(grid.shape)}")


def _grid_sample_forward(image, grid, padding_mode):
    _check("grid_sample", image, grid, padding_mode)
    B, H, W, C = image.shape
    _, Ho, Wo, _ = grid.shape
    image = image.detach().contiguous()
    grid = grid.detach().float().contiguous()
    out = torch.empty((B, Ho, Wo, C), dtype=image.dtype, device=image.device)
    _build.launch("grid_sample", "grid_sample", _build.dtype_code(image.dtype),
                  image.data_ptr(), grid.data_ptr(), out.data_ptr(), B, H, W, C, Ho, Wo,
                  PADDING_MODES.index(padding_mode), _build.stream(image))
    grid_sample.launches += 1
    return out


class _GridSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, image, grid, padding_mode):
        ctx.padding_mode = padding_mode
        ctx.save_for_backward(image, grid)
        return _grid_sample_forward(image, grid, padding_mode)

    @staticmethod
    def backward(ctx, g):
        image, grid = ctx.saved_tensors
        d_image, d_grid = grid_sample_bwd(g, image, grid, ctx.padding_mode,
                                          image_grad=ctx.needs_input_grad[0],
                                          grid_grad=ctx.needs_input_grad[1])
        return d_image, d_grid, None


def grid_sample(image: torch.Tensor, grid: torch.Tensor,
                padding_mode: str = "zeros") -> torch.Tensor:
    """image (B, H, W, C), grid (B, Ho, Wo, 2) -> (B, Ho, Wo, C), align_corners=True."""
    if image.device.type == "cpu":
        return grid_sample_plain(image, grid, padding_mode)
    if _needs_grad(image, grid):
        return _GridSample.apply(image, grid, padding_mode)
    return _grid_sample_forward(image, grid, padding_mode)


grid_sample.launches = 0


def grid_sample_bwd(g: torch.Tensor, image: torch.Tensor, grid: torch.Tensor,
                    padding_mode: str = "zeros", image_grad: bool = True,
                    grid_grad: bool = True) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Kernel 8: (d_image, d_grid) of ``grid_sample`` at (image, grid) for the
    cotangent g (B, Ho, Wo, C), each in its operand's dtype; None where its
    flag is off (the kernel then does none of that output's work)."""
    if image.device.type == "cpu":
        d_image, d_grid = grid_sample_plain_vjp(g, image, grid, padding_mode)
        return (d_image if image_grad else None), (d_grid if grid_grad else None)
    _check("grid_sample_bwd", image, grid, padding_mode)
    B, H, W, C = image.shape
    _, Ho, Wo, _ = grid.shape
    if g.device != image.device or tuple(g.shape) != (B, Ho, Wo, C):
        raise ValueError(f"grid_sample_bwd: cotangent {tuple(g.shape)} on {g.device}")
    if not (image_grad or grid_grad):
        return None, None
    image_c = image.detach().contiguous()
    grid_c = grid.detach().float().contiguous()
    g_c = g.detach().to(image.dtype).contiguous()
    f32 = dict(dtype=torch.float32, device=image.device)
    d_image = torch.zeros((B, H, W, C), **f32) if image_grad else None
    d_grid = torch.empty((B, Ho, Wo, 2), **f32) if grid_grad else None
    P = _build.ptr
    _build.launch("grid_sample", "grid_sample_bwd", _build.dtype_code(image.dtype),
                  P(image_c), P(grid_c), P(g_c), P(d_image), P(d_grid), B, H, W, C, Ho, Wo,
                  PADDING_MODES.index(padding_mode), _build.stream(image))
    grid_sample_bwd.launches += 1
    return (None if d_image is None else d_image.to(image.dtype),
            None if d_grid is None else d_grid.to(grid.dtype))


grid_sample_bwd.launches = 0


def grid_sample_plain_vjp(g: torch.Tensor, image: torch.Tensor, grid: torch.Tensor,
                          padding_mode: str = "zeros"):
    """The plain version of kernel 8: autograd of ``grid_sample_plain``,
    (d_image, d_grid)."""
    return plain_vjp(grid_sample_plain, g, image, grid, padding_mode=padding_mode)
