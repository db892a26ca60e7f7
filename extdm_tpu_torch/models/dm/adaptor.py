"""Motion adaptor, the distribution-extrapolation module (port of
extdm_tpu/models/dm/adaptor.py). Layout (B, T, H, W, C); parameter names are
the reference denoiser's (``adaptors.predictor.fn.norm.gamma``, ...)."""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from extdm_tpu_torch.nn.layers import chan_layer_norm


class ChanLayerNorm(nn.Module):
    """Channel LayerNorm, gamma only, biased variance (reference LayerNorm)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(1, dim, 1, 1, 1))

    def forward(self, x):
        return chan_layer_norm(x, self.gamma, self.eps)


class PreNorm(nn.Module):
    """fn(ChanLayerNorm(x))."""

    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = ChanLayerNorm(dim)
        self.fn = fn

    def forward(self, x):
        return self.fn(self.norm(x))


class Residual(nn.Module):
    """x + fn(x)."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return x + self.fn(x)


class PointwiseConv3d(nn.Conv3d):
    """1x1x1 Conv3d on (..., C) tensors, as a product over channels."""

    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__(cin, cout, 1, bias=bias)

    def forward(self, x):
        return F.linear(x.to(self.weight.dtype), self.weight.flatten(1), self.bias)


class Conv3x3x3(nn.Conv3d):
    """Bias-free 3x3x3 Conv3d, zero padded, on (B, T, H, W, C) tensors."""

    def __init__(self, dim: int):
        super().__init__(dim, dim, 3, padding=1, bias=False)

    def forward(self, x):
        return super().forward(x.to(self.weight.dtype).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)


def compute_layer(tm: int, tp: int):
    """Cond-window doublings needed to cover tp (+1) frames, and the frames made."""
    num_layers = max(1, int(math.ceil(math.log2((tp + 1) / tm))))
    return num_layers, (2 ** num_layers - 1) * tm


class Extrapolator(nn.Module):
    """Normalise per (sample, channel) over (T, H, W) with an unbiased
    variance, add a 3x3x3 residual conv, re-scale and append along T,
    doubling the window per layer; returns only the new frames."""

    def __init__(self, dim: int, num_layers: int):
        super().__init__()
        self.predictor = Residual(PreNorm(dim, PointwiseConv3d(dim, dim)))
        self.extrapolators = nn.ModuleList(Residual(Conv3x3x3(dim)) for _ in range(num_layers))

    def forward(self, xm):
        tm = xm.shape[1]
        x = self.predictor(xm)
        for ext in self.extrapolators:
            r = x
            x32 = x.float()
            mean = x32.mean(dim=(1, 2, 3), keepdim=True)
            var = x32.reshape(x.shape[0], -1, x.shape[-1]).var(dim=1, unbiased=True)
            std = torch.sqrt(var + 1e-5)[:, None, None, None, :]
            xh = ext(((x32 - mean) / std).to(x.dtype))
            x = torch.cat([r, (xh.float() * std + mean).to(x.dtype)], dim=1)
        return x[:, tm:]


class MotionAdaptor(nn.Module):
    """Extrapolate the cond-frame features into the prediction window and
    fuse them with the prediction stream (T-major fuse)."""

    def __init__(self, dim: int, tc: int, tp: int):
        super().__init__()
        self.tc, self.tp = tc, tp
        num_layers, self.num_frames = compute_layer(tc, tp)
        self.adaptors = Extrapolator(dim, num_layers)
        self.Tmodulator = nn.Conv2d(self.num_frames * dim, tp * dim, 1)
        self.fuser = PreNorm(2 * dim, PointwiseConv3d(2 * dim, dim))

    def forward(self, x):
        B, T, H, W, C = x.shape
        if T != self.tc + self.tp:
            raise ValueError(f"{T} frames, the adaptor was built for {self.tc} + {self.tp}")
        xm, xp = x[:, :self.tc], x[:, self.tc:]
        xm2p = self.adaptors(xm)  # (B, nf, H, W, C)
        w3 = self.Tmodulator.weight.reshape(self.tp * C, self.num_frames, C)
        y = torch.einsum("bfhwc,ofc->bhwo", xm2p.to(w3.dtype), w3) + self.Tmodulator.bias
        y = y.reshape(B, H, W, self.tp, C).permute(0, 3, 1, 2, 4)
        fused = self.fuser(torch.cat([y, xp.to(y.dtype)], dim=-1))
        return torch.cat([xm, fused + xp], dim=1)
