"""Gaussian-prefiltered downsampling (port of extdm_tpu/ops/antialias.py):
one strided depthwise convolution that blurs and subsamples at once."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel_1d(scale: float) -> np.ndarray:
    sigma = (1.0 / scale - 1.0) / 2.0
    ksize = 2 * round(sigma * 4) + 1
    xs = np.arange(ksize, dtype=np.float64)
    mean = (ksize - 1) / 2.0
    return np.exp(-((xs - mean) ** 2) / (2.0 * sigma ** 2))


def antialias_downsample(x: torch.Tensor, scale: float) -> torch.Tensor:
    """(B, H, W, C) -> (B, H*scale, W*scale, C); `scale` is 1/int or 1."""
    if scale == 1.0:
        return x
    stride = int(round(1.0 / scale))
    if abs(1.0 / scale - stride) > 1e-6:
        raise ValueError(f"scale must be 1/int, got {scale}")
    k1 = gaussian_kernel_1d(scale)
    k2 = np.outer(k1, k1)
    k2 = k2 / k2.sum()
    ksize = k2.shape[0]
    ka = ksize // 2
    kb = ka - 1 if ksize % 2 == 0 else ka
    C = x.shape[-1]
    kernel = torch.as_tensor(k2, dtype=x.dtype, device=x.device).expand(C, 1, ksize, ksize)
    xp = F.pad(x.permute(0, 3, 1, 2), (ka, kb, ka, kb))
    return F.conv2d(xp, kernel, stride=stride, groups=C).permute(0, 2, 3, 1)
