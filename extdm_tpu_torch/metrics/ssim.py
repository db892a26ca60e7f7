"""SSIM over videos (port of extdm_tpu/metrics/ssim.py), in float64 on the
videos' device: an 11x11 Gaussian window (sigma 1.5, cv2's
getGaussianKernel), applied as two separable passes over the valid region,
the SSIM map's mean per channel, the channels' mean per frame; the same
1 / 2 / 3 aggregations as PSNR. Videos are channels-first (B, T, C, H, W),
or (B, T, H, W) gray, with H and W at least 11.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from extdm_tpu_torch.metrics.psnr import as_float64

C1, C2 = 0.01 ** 2, 0.03 ** 2
CHUNK = 4096  # images filtered at once


def gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """cv2.getGaussianKernel(size, sigma) as a float64 vector."""
    xs = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    return k / k.sum()


def _ssim_images(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, 1, H, W) float64 pairs -> (N,) mean SSIM over the valid region."""
    k = torch.as_tensor(gaussian_kernel(), device=a.device)

    def blur(x):
        return F.conv2d(F.conv2d(x, k.view(1, 1, -1, 1)), k.view(1, 1, 1, -1))

    mu1, mu2 = blur(a), blur(b)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    s1 = blur(a * a) - mu1_sq
    s2 = blur(b * b) - mu2_sq
    s12 = blur(a * b) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * s12 + C2)) / ((mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))
    return ssim_map.mean(dim=(1, 2, 3))


def _per_frame_ssim(videos1, videos2) -> torch.Tensor:
    v1, v2 = as_float64(videos1, videos2)
    if v1.ndim == 5 and (v1.shape[3] < 11 or v1.shape[4] < 11):
        raise ValueError(f"SSIM expects channels-first (B, T, C, H, W) with H, W >= 11; got "
                         f"{tuple(v1.shape)} (channels-last input? transpose first)")
    B, T = v1.shape[:2]
    H, W = v1.shape[-2:]
    a, b = v1.reshape(-1, 1, H, W), v2.reshape(-1, 1, H, W)
    per_image = torch.cat([_ssim_images(a[i:i + CHUNK], b[i:i + CHUNK])
                           for i in range(0, a.shape[0], CHUNK)])
    return per_image.reshape(B, T, -1).mean(dim=-1)


def calculate_ssim1(videos1, videos2) -> Tuple[Dict, Dict]:
    mat = _per_frame_ssim(videos1, videos2).cpu().numpy()
    per_video = mat.mean(axis=1)
    return ({"ssim": per_video.mean(), "ssim_per_frame": mat.mean(axis=0)},
            {"ssim": per_video.std(), "ssim_per_frame": mat.std(axis=0)})


def calculate_ssim2(videos1, videos2, num_sample: int) -> float:
    mat = _per_frame_ssim(videos1, videos2).mean(dim=1).reshape(-1, num_sample)
    return float(mat.max(dim=1).values.mean())


def calculate_ssim3(videos1, videos2) -> np.ndarray:
    return _per_frame_ssim(videos1, videos2).cpu().numpy()
