"""Random Fourier positional features for (B, T, H, W, C) volumes (port of
extdm_tpu/models/dm/fourier.py; the reference's FourierEncoding3D, present
but unused by its denoisers).

sin and cos of 2 pi (t, h, w) . f for ``num_frequencies`` random frequency
vectors f, drawn from ``numpy.random.RandomState(seed)`` as the JAX module
draws them, over coordinates in [-1, 1]; a bias-free ``proj`` maps the
2 F features to C channels, added to x. ``dtype`` is the compute type
(None: x's type).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


class FourierEncoding3D(nn.Module):
    def __init__(self, dim: int, num_frequencies: int = 10, seed: int = 0, dtype=None):
        super().__init__()
        self.num_frequencies, self.seed, self.compute_dtype = num_frequencies, seed, dtype
        self.proj = nn.Linear(2 * num_frequencies, dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, H, W, _ = x.shape
        freqs = np.random.RandomState(self.seed).randn(3, self.num_frequencies).astype(np.float32)
        tt, hh, ww = np.meshgrid(np.linspace(-1, 1, T), np.linspace(-1, 1, H),
                                 np.linspace(-1, 1, W), indexing="ij")
        angles = 2 * np.pi * np.stack([tt, hh, ww], -1) @ freqs  # (T, H, W, F)
        dt = self.compute_dtype or x.dtype
        feats = torch.as_tensor(np.concatenate([np.sin(angles), np.cos(angles)], -1), dtype=dt,
                                device=x.device)
        return x + F.linear(feats, self.proj.weight.to(dt)).expand(B, -1, -1, -1, -1)
