"""Motion adaptor, the distribution-extrapolation module, and the
trajectory warp of the ``w_ref/traj`` denoisers (port of
extdm_tpu/models/dm/adaptor.py). Layout (B, T, H, W, C); parameter names are
the reference denoiser's (``adaptors.predictor.fn.norm.gamma``, ...).

Each module takes an explicit compute ``dtype`` (None: float32), as the flax
modules do: parameters keep their own dtype (float32 when training) and are
cast to the compute type where they are used; norm statistics stay float32.

``MotionAdaptor`` also runs on an H shard (``shard``, a
``parallel.SpatialMesh``; inference): the extrapolator's per-(sample,
channel) statistics over (T, H, W) are combined over the shards
(``SpatialMesh.moments``, the global count in the unbiased variance) and
its 3x3x3 convolutions read one halo row of each neighbour; the rest acts
on each pixel alone. ``TrajWarp`` runs on a shard with no exchange of its
own (see its docstring)."""
from __future__ import annotations

import math
import torch
import torch.nn as nn
import torch.nn.functional as F

from extdm_tpu_torch.nn.layers import cast, chan_layer_norm


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

    def __init__(self, cin: int, cout: int, bias: bool = True, dtype=None):
        super().__init__(cin, cout, 1, bias=bias)
        self.compute_dtype = dtype or torch.float32

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.flatten(1).to(dt), cast(self.bias, dt))


class Conv3x3x3(nn.Conv3d):
    """Bias-free 3x3x3 Conv3d, zero padded, on (B, T, H, W, C) tensors."""

    def __init__(self, dim: int, dtype=None):
        super().__init__(dim, dim, 3, padding=1, bias=False)
        self.compute_dtype = dtype or torch.float32

    def forward(self, x, shard=None):
        dt = self.compute_dtype
        if shard is None:
            y = self._conv_forward(x.to(dt).permute(0, 4, 1, 2, 3), self.weight.to(dt), None)
        else:  # the H padding is the neighbours' rows (zeros past the global edges)
            xh = shard.halo(x.to(dt), 1, 1, "zero")
            y = F.conv3d(xh.permute(0, 4, 1, 2, 3), self.weight.to(dt), None, padding=(1, 0, 1))
        return y.permute(0, 2, 3, 4, 1)


def compute_layer(tm: int, tp: int):
    """Cond-window doublings needed to cover tp (+1) frames, and the frames made."""
    num_layers = max(1, int(math.ceil(math.log2((tp + 1) / tm))))
    return num_layers, (2 ** num_layers - 1) * tm


class Extrapolator(nn.Module):
    """Normalise per (sample, channel) over (T, H, W) with an unbiased
    variance, add a 3x3x3 residual conv, re-scale and append along T,
    doubling the window per layer; returns only the new frames."""

    def __init__(self, dim: int, num_layers: int, dtype=None):
        super().__init__()
        self.predictor = Residual(PreNorm(dim, PointwiseConv3d(dim, dim, dtype=dtype)))
        self.extrapolators = nn.ModuleList(Residual(Conv3x3x3(dim, dtype)) for _ in range(num_layers))

    def forward(self, xm, shard=None):
        tm = xm.shape[1]
        x = self.predictor(xm)
        for ext in self.extrapolators:
            r = x
            x32 = x.float()
            if shard is None:
                mean = x32.mean(dim=(1, 2, 3), keepdim=True)
                var = x32.reshape(x.shape[0], -1, x.shape[-1]).var(dim=1, unbiased=True)
                std = torch.sqrt(var + 1e-5)[:, None, None, None, :]
                xh = ext(((x32 - mean) / std).to(x.dtype))
            else:
                mean, m2, n = shard.moments(x32, (1, 2, 3))
                std = torch.sqrt(m2 / (n - 1) + 1e-5)
                xn = ((x32 - mean) / std).to(x.dtype)
                xh = xn + ext.fn(xn, shard)
            x = torch.cat([r, (xh.float() * std + mean).to(x.dtype)], dim=1)
        return x[:, tm:]


class MotionAdaptor(nn.Module):
    """Extrapolate the cond-frame features into the prediction window and
    fuse them with the prediction stream (T-major fuse)."""

    def __init__(self, dim: int, tc: int, tp: int, dtype=None):
        super().__init__()
        self.tc, self.tp = tc, tp
        self.compute_dtype = dtype or torch.float32
        num_layers, self.num_frames = compute_layer(tc, tp)
        self.adaptors = Extrapolator(dim, num_layers, dtype)
        self.Tmodulator = nn.Conv2d(self.num_frames * dim, tp * dim, 1)
        self.fuser = PreNorm(2 * dim, PointwiseConv3d(2 * dim, dim, dtype=dtype))

    def forward(self, x, shard=None):
        B, T, H, W, C = x.shape
        if T != self.tc + self.tp:
            raise ValueError(f"{T} frames, the adaptor was built for {self.tc} + {self.tp}")
        xm, xp = x[:, :self.tc], x[:, self.tc:]
        xm2p = self.adaptors(xm, shard)  # (B, nf, H, W, C)
        dt = self.compute_dtype
        w3 = self.Tmodulator.weight.reshape(self.tp * C, self.num_frames, C).to(dt)
        y = torch.einsum("bfhwc,ofc->bhwo", xm2p.to(dt), w3) + self.Tmodulator.bias.to(dt)
        y = y.reshape(B, H, W, self.tp, C).permute(0, 3, 1, 2, 4)
        fused = self.fuser(torch.cat([y, xp.to(y.dtype)], dim=-1))
        return torch.cat([xm, fused + xp], dim=1)


class TrajWarp(nn.Module):
    """Cross-attention feature warp of the ``traj_u12/u22`` denoisers: the
    noisy prediction stream, max-pooled 2x to the features' size, queries the
    cond frames' features; the attended features are fused into the
    prediction frames' features.

    ``forward(xp, f)``: xp (B, tp, 2H, 2W, C) the lifted noisy latents, f
    (B, tc + tp, H, W, C) the features. q, k and v are ReLU'd projections
    (pred tokens tp H W attend to cond tokens tc H W, ``heads`` heads of C /
    heads), the attention output a ReLU'd projection; then [f_pred, warped]
    -> 1x1x1 ``fuser``. The attention is plain in the JAX package (no TPU
    kernel), here ``F.scaled_dot_product_attention`` on every device, which
    on the card does not keep the (tp H W) x (tc H W) score matrix.

    On an H shard (``shard``, a ``parallel.SpatialMesh``; inference): xp is
    the shard's rows of the lifted latents and f is whole on every rank, as
    the UNet's cond features are. The 2x2 max-pool stays within the shard
    (its rows must be even), K and V come from the whole cond frames, each
    query row's softmax is its own, and the 1x1x1 fuser acts on each pixel:
    the shard's rows of the result need no exchange. Returns the shard's
    rows of the (B, tc + tp, H, W, C) result."""

    def __init__(self, dim: int, tc: int, tp: int, heads: int = 8, dtype=None):
        super().__init__()
        self.tc, self.tp, self.heads = tc, tp, heads
        self.compute_dtype = dtype or torch.float32
        self.linear_q, self.linear_k = nn.Linear(dim, dim), nn.Linear(dim, dim)
        self.linear_v, self.linear_o = nn.Linear(dim, dim), nn.Linear(dim, dim)
        self.fuser = PointwiseConv3d(2 * dim, dim, dtype=dtype)

    def _dense(self, lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.relu(F.linear(x.to(dt), lin.weight.to(dt), lin.bias.to(dt)))

    def forward(self, xp: torch.Tensor, f: torch.Tensor, shard=None) -> torch.Tensor:
        B, T, _, W, C = f.shape
        fm, fp = f[:, :self.tc], f[:, self.tc:]
        if shard is not None:
            if xp.shape[2] % 2:
                raise ValueError(f"the 2x2 max-pool on an H shard of {xp.shape[2]} rows: a "
                                 "shard's rows must be even")
            fm, fp = shard.slice_h(fm), shard.slice_h(fp)
        H = fp.shape[2]
        xp = F.max_pool2d(xp.reshape(B * self.tp, *xp.shape[2:]).permute(0, 3, 1, 2), 2, 2)
        if tuple(xp.shape[2:]) != (H, W):
            raise ValueError(f"pooled queries {tuple(xp.shape[2:])} != features {(H, W)}")
        q = xp.permute(0, 2, 3, 1).reshape(B, -1, C)
        kv = f[:, :self.tc].reshape(B, -1, C)  # every cond token, also on a shard

        def heads(a):
            return a.reshape(B, a.shape[1], self.heads, C // self.heads).transpose(1, 2)

        q, k, v = (heads(self._dense(lin, a)) for lin, a in
                   ((self.linear_q, q), (self.linear_k, kv), (self.linear_v, kv)))
        out = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(B, -1, C)
        warped = self._dense(self.linear_o, out).reshape(B, self.tp, H, W, C)
        return torch.cat([fm, self.fuser(torch.cat([fp, warped], dim=-1))], dim=1)
