"""PSNR over videos (port of extdm_tpu/metrics/psnr.py), in float64 on the
videos' device: per-frame MSE -> dB (100 where the MSE is below 1e-10),
per-video mean over frames, then
- ``calculate_psnr1``: mean / std over videos, and per frame;
- ``calculate_psnr2``: best of n trajectories (max of the per-video means);
- ``calculate_psnr3``: the (video, frame) matrix.
Videos (B, T, C, H, W) or (B, T, H, W, C) in [0, 1], tensors or arrays.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def as_float64(videos1, videos2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both videos as float64 tensors on the first one's device."""
    v1 = torch.as_tensor(videos1)
    v2 = torch.as_tensor(videos2, device=v1.device)
    if v1.shape != v2.shape:
        raise ValueError(f"videos of shapes {tuple(v1.shape)} and {tuple(v2.shape)}")
    return v1.double(), v2.double()


def _per_frame_psnr(videos1, videos2) -> torch.Tensor:
    v1, v2 = as_float64(videos1, videos2)
    mse = ((v1 - v2) ** 2).mean(dim=tuple(range(2, v1.ndim)))
    psnr = 20 * torch.log10(1.0 / torch.sqrt(mse))
    return torch.where(mse < 1e-10, torch.full_like(psnr, 100.0), psnr)


def calculate_psnr1(videos1, videos2) -> Tuple[Dict, Dict]:
    mat = _per_frame_psnr(videos1, videos2).cpu().numpy()
    per_video = mat.mean(axis=1)
    return ({"psnr": per_video.mean(), "psnr_per_frame": mat.mean(axis=0)},
            {"psnr": per_video.std(), "psnr_per_frame": mat.std(axis=0)})


def calculate_psnr2(videos1, videos2, num_sample: int) -> float:
    """Best of n: (B*n, T, ...) trajectories against the (B*n, T, ...) real
    videos repeated n times; the mean over videos of the best trajectory."""
    mat = _per_frame_psnr(videos1, videos2).mean(dim=1).reshape(-1, num_sample)
    return float(mat.max(dim=1).values.mean())


def calculate_psnr3(videos1, videos2) -> np.ndarray:
    return _per_frame_psnr(videos1, videos2).cpu().numpy()
