"""Kernel 4 of the sampling path: bilinear grid sample (``csrc/grid_sample.cu``).

Replaces ``extdm_tpu/ops/pallas_warp.py`` ``grid_sample`` (its one-hot-matmul
Pallas kernel, ``_make_kernel``). The H100 is bound by bytes here: a direct
four-corner gather with one thread per (output pixel, channel), channel
fastest, so all reads and writes coalesce for any channel count; the JAX
package's VMEM/tileability gate (``pallas_warp.supported``) has no
counterpart, and every warp of the path goes through the kernel.

``grid_sample`` runs the kernel for CUDA tensors and the plain version
(``grid_sample_plain``) for CPU tensors; ``grid_sample.launches`` counts
kernel launches.
"""
from __future__ import annotations

import torch

from extdm_tpu_torch import _build
from extdm_tpu_torch.ops.warp import PADDING_MODES, grid_sample_plain

__all__ = ["grid_sample", "grid_sample_plain"]


def grid_sample(image: torch.Tensor, grid: torch.Tensor,
                padding_mode: str = "zeros") -> torch.Tensor:
    """image (B, H, W, C), grid (B, Ho, Wo, 2) -> (B, Ho, Wo, C), align_corners=True."""
    if image.device.type == "cpu":
        return grid_sample_plain(image, grid, padding_mode)
    if not (image.is_cuda and grid.device == image.device):
        raise ValueError(f"grid_sample: image on {image.device}, grid on {grid.device}")
    if padding_mode not in PADDING_MODES:
        raise ValueError(f"unknown padding_mode: {padding_mode}")
    B, H, W, C = image.shape
    Bg, Ho, Wo, two = grid.shape
    if Bg != B or two != 2:
        raise ValueError(f"grid_sample: image {tuple(image.shape)} vs grid {tuple(grid.shape)}")
    image = image.contiguous()
    grid = grid.float().contiguous()
    out = torch.empty((B, Ho, Wo, C), dtype=image.dtype, device=image.device)
    _build.launch("grid_sample", "grid_sample", _build.dtype_code(image.dtype),
                  image.data_ptr(), grid.data_ptr(), out.data_ptr(), B, H, W, C, Ho, Wo,
                  PADDING_MODES.index(padding_mode), _build.stream(image))
    grid_sample.launches += 1
    return out


grid_sample.launches = 0
