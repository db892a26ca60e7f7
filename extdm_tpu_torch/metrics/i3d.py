"""Inception-I3D feature extractor for FVD (port of extdm_tpu/metrics/i3d.py):
Inception-v1 inflated to 3-D, TF-style SAME padding, BatchNorm (eps 1e-3),
and the 400-way logits head averaged over time; ``forward`` returns the
400-d pre-softmax features. Parameter names are the reference
``pytorch_i3d`` ones (``Conv3d_1a_7x7.conv3d.weight``, ``Mixed_3b.b1b.bn.
running_mean``, ``logits.conv3d.bias``, ...). Input (B, T, H, W, 3) in
[-1, 1], channels-last as the JAX module's; NCDHW inside.

The final average pool clamps its temporal kernel to the frames left (8
input frames reach it with T' = 1, where a kernel of 2 would give an empty
map and NaN features) and refuses spatial maps under 7x7.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

INCEPTION_CHANNELS = {
    "Mixed_3b": [64, 96, 128, 16, 32, 32],
    "Mixed_3c": [128, 128, 192, 32, 96, 64],
    "Mixed_4b": [192, 96, 208, 16, 48, 64],
    "Mixed_4c": [160, 112, 224, 24, 64, 64],
    "Mixed_4d": [128, 128, 256, 24, 64, 64],
    "Mixed_4e": [112, 144, 288, 32, 64, 64],
    "Mixed_4f": [256, 160, 320, 32, 128, 128],
    "Mixed_5b": [256, 160, 320, 32, 128, 128],
    "Mixed_5c": [384, 192, 384, 48, 128, 128],
}


def _same_pad(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF SAME padding (before, after) of one dimension."""
    pad = max(kernel - (stride if size % stride == 0 else size % stride), 0)
    return pad // 2, pad - pad // 2


def _pad_same(x: torch.Tensor, kernel, stride, value: float = 0.0) -> torch.Tensor:
    pads = [_same_pad(s, k, st) for s, k, st in zip(x.shape[2:], kernel, stride)]
    flat = [p for pair in reversed(pads) for p in pair]  # F.pad: last dim first
    return F.pad(x, flat, value=value)


def max_pool_same(x: torch.Tensor, kernel: Sequence[int], stride: Sequence[int]) -> torch.Tensor:
    """Max pool with TF SAME padding by -inf, on (B, C, T, H, W)."""
    return F.max_pool3d(_pad_same(x, kernel, stride, float("-inf")), tuple(kernel),
                        tuple(stride))


class Unit3D(nn.Module):
    def __init__(self, c_in: int, c_out: int, kernel=(1, 1, 1), stride=(1, 1, 1),
                 use_bn: bool = True, activation: bool = True, use_bias: bool = False,
                 bn_eps: float = 1e-3):
        super().__init__()
        self.kernel, self.stride, self.activation = tuple(kernel), tuple(stride), activation
        self.conv3d = nn.Conv3d(c_in, c_out, self.kernel, self.stride, bias=use_bias)
        self.bn = nn.BatchNorm3d(c_out, eps=bn_eps) if use_bn else None

    def forward(self, x):
        x = self.conv3d(_pad_same(x, self.kernel, self.stride))
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.activation else x


class InceptionModule(nn.Module):
    def __init__(self, c_in: int, oc: Sequence[int], bn_eps: float = 1e-3):
        super().__init__()
        self.b0 = Unit3D(c_in, oc[0], bn_eps=bn_eps)
        self.b1a = Unit3D(c_in, oc[1], bn_eps=bn_eps)
        self.b1b = Unit3D(oc[1], oc[2], (3, 3, 3), bn_eps=bn_eps)
        self.b2a = Unit3D(c_in, oc[3], bn_eps=bn_eps)
        self.b2b = Unit3D(oc[3], oc[4], (3, 3, 3), bn_eps=bn_eps)
        self.b3b = Unit3D(c_in, oc[5], bn_eps=bn_eps)

    def forward(self, x):
        b3 = self.b3b(max_pool_same(x, (3, 3, 3), (1, 1, 1)))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)), b3], dim=1)


def _out_channels(oc: Sequence[int]) -> int:
    return oc[0] + oc[2] + oc[4] + oc[5]


class InceptionI3d(nn.Module):
    """(B, T, H, W, 3) in [-1, 1] -> (B, num_classes) features."""

    def __init__(self, num_classes: int = 400, bn_eps: float = 1e-3):
        super().__init__()
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2), bn_eps=bn_eps)
        self.Conv3d_2b_1x1 = Unit3D(64, 64, bn_eps=bn_eps)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3), bn_eps=bn_eps)
        c = 192
        for name, oc in INCEPTION_CHANNELS.items():
            setattr(self, name, InceptionModule(c, oc, bn_eps))
            c = _out_channels(oc)
        self.logits = Unit3D(c, num_classes, use_bn=False, activation=False, use_bias=True)

    def forward(self, x):
        x = x.permute(0, 4, 1, 2, 3)
        x = self.Conv3d_1a_7x7(x)
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Mixed_3c(self.Mixed_3b(x))
        x = max_pool_same(x, (3, 3, 3), (2, 2, 2))
        for name in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f"):
            x = getattr(self, name)(x)
        x = max_pool_same(x, (2, 2, 2), (2, 2, 2))
        x = self.Mixed_5c(self.Mixed_5b(x))
        if x.shape[3] < 7 or x.shape[4] < 7:
            raise ValueError(f"I3D spatial map {x.shape[3]}x{x.shape[4]} < 7x7 before the final "
                             "avg_pool: input frames were not preprocessed to 224x224")
        x = F.avg_pool3d(x, (min(2, x.shape[2]), 7, 7), stride=1)
        x = self.logits(x)  # (B, classes, T', 1, 1)
        return x.flatten(2).mean(dim=2)
