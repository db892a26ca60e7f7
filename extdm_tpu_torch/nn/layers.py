"""LFAE building blocks (port of extdm_tpu/nn/layers.py), channels-last.

Convolutions and BatchNorm take (B, H, W, C) tensors and keep PyTorch's
parameter layouts and the reference LFAE's state-dict names. These convs
sit outside every TPU kernel of the JAX package, so they stay cuDNN
convolutions here.

Dtype policy, as in the flax modules: each layer and block takes a compute
``dtype`` (None: float32). Parameters and BatchNorm statistics keep their
own type (float32 master weights when training; the DM stores its frozen
LFAE in its compute type); a conv casts its input and weights to the
compute type, and BatchNorm reduces in float32 and returns the compute type.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from extdm_tpu_torch.ops.resize import avg_pool_2x2, upsample_nearest
from extdm_tpu_torch.parallel.mesh import all_mean_autograd


def chan_layer_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last (channel) axis with a scale only and biased
    variance; float32 statistics, output in x.dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps) * gamma.float().reshape(-1)).to(x.dtype)


def cast(t: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


class Conv2d(nn.Conv2d):
    """nn.Conv2d on channels-last (B, H, W, C) tensors, computing in `dtype`
    (None: float32): input, weight and bias are cast to it."""

    def __init__(self, cin: int, cout: int, kernel_size: int, padding: int = 0, dtype=None):
        super().__init__(cin, cout, kernel_size, padding=padding)
        self.compute_dtype = dtype or torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = self._conv_forward(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt),
                               cast(self.bias, dt))
        return y.permute(0, 2, 3, 1)


# SyncBN (JAX ``sync_bn_axis``, nn/layers.py:117-133): within the scope,
# every BatchNorm in train mode takes its statistics over the data group's
# global batch.
_SYNC_BN_GROUP: contextvars.ContextVar = contextvars.ContextVar("sync_bn_group", default=None)


@contextlib.contextmanager
def sync_bn_group(group):
    """Within this scope, BatchNorm in train mode averages the batch mean
    and mean of squares over the ranks of `group` (a
    ``parallel.DataGroup``) and normalizes with the global statistics, as
    flax ``BatchNorm(axis_name=...)`` under ``sync_bn_axis`` does; its
    running statistics move toward the global biased variance."""
    token = _SYNC_BN_GROUP.set(group)
    try:
        yield
    finally:
        _SYNC_BN_GROUP.reset(token)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d on (B, H, W, C) tensors with flax's statistics update,
    returning `dtype` (None: float32).

    In eval mode (the LFAE frozen inside the diffusion model) it normalizes
    with the running statistics. In train mode (stage-1 training) it
    normalizes with the batch's and moves the running statistics by
    ``momentum`` toward the batch mean and the *biased* batch variance, as
    flax ``nn.BatchNorm(momentum=0.9)`` does; ``F.batch_norm`` would move
    them toward the unbiased variance. Where the parameters are kept in
    another type than the compute type (float32 master weights under a bf16
    policy), the input is cast to float32, normalized there and the result
    cast to the compute type, as flax's BatchNorm promotes to its float32
    parameters and casts its output; where they are kept in the compute
    type (the DM's frozen LFAE), it normalizes in that type. Under
    ``sync_bn_group`` with more than one rank, train mode takes flax's
    cross-replica statistics instead: the mean and mean of squares, in
    float32, averaged over the ranks (the backward averages their
    cotangents too), and var = E[x^2] - E[x]^2."""

    def __init__(self, features: int, dtype=None):
        super().__init__(features)
        self.compute_dtype = dtype or torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = x.permute(0, 3, 1, 2).to(self.weight.dtype)
        if not self.training:
            y = F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                             False, 0.0, self.eps)
            return y.permute(0, 2, 3, 1).to(dt)
        group = _SYNC_BN_GROUP.get()
        if group is not None and group.parallel:
            return self._synced(x, group).permute(0, 2, 3, 1).to(dt)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
            self._track(mean, var)
        # no running statistics here: autograd would keep them for the
        # backward, and the module's next call in this step updates them
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        return y.permute(0, 2, 3, 1).to(dt)

    def _track(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """Running statistics moved by ``momentum`` toward (mean, biased var)."""
        self.running_mean.lerp_(mean.to(self.running_mean.dtype), self.momentum)
        self.running_var.lerp_(var.to(self.running_var.dtype), self.momentum)

    def _synced(self, x: torch.Tensor, group) -> torch.Tensor:
        """Train-mode normalization of (B, C, H, W) `x` with the group's
        global statistics (one all-reduce of [mean, mean of squares])."""
        x32 = x.float()
        moments = torch.stack([x32.mean(dim=(0, 2, 3)), (x32 * x32).mean(dim=(0, 2, 3))])
        mean, mean_sq = all_mean_autograd(moments, group)
        var = (mean_sq - mean * mean).clamp(min=0.0)
        with torch.no_grad():
            self._track(mean, var)
        scale = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (x32 - mean[:, None, None]) * scale[:, None, None] + self.bias.float()[:, None, None]
        return y.to(x.dtype)


class SameBlock2d(nn.Module):
    """conv -> BN -> ReLU, same resolution."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3, dtype=None):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel_size, padding=kernel_size // 2, dtype=dtype)
        self.norm = BatchNorm(cout, dtype)

    def forward(self, x):
        return F.relu(self.norm(self.conv(x)))


class DownBlock2d(SameBlock2d):
    """conv -> BN -> ReLU -> 2x2 average pool."""

    def forward(self, x):
        return avg_pool_2x2(super().forward(x))


class UpBlock2d(SameBlock2d):
    """nearest 2x upsample -> conv -> BN -> ReLU."""

    def forward(self, x):
        return super().forward(upsample_nearest(x, 2))


class ResBlock2d(nn.Module):
    """(BN -> ReLU -> conv) twice, plus the input."""

    def __init__(self, features: int, kernel_size: int = 3, dtype=None):
        super().__init__()
        pad = kernel_size // 2
        self.norm1 = BatchNorm(features, dtype)
        self.conv1 = Conv2d(features, features, kernel_size, padding=pad, dtype=dtype)
        self.norm2 = BatchNorm(features, dtype)
        self.conv2 = Conv2d(features, features, kernel_size, padding=pad, dtype=dtype)

    def forward(self, x):
        h = self.conv1(F.relu(self.norm1(x)))
        return self.conv2(F.relu(self.norm2(h))) + x


class Encoder(nn.Module):
    """Hourglass encoder; returns [input, d1, ..., dN]."""

    def __init__(self, block_expansion: int, in_features: int, num_blocks: int = 3,
                 max_features: int = 256, dtype=None):
        super().__init__()
        chans = [in_features] + [min(max_features, block_expansion * 2 ** (i + 1))
                                 for i in range(num_blocks)]
        self.down_blocks = nn.ModuleList(DownBlock2d(chans[i], chans[i + 1], dtype=dtype)
                                         for i in range(num_blocks))

    def forward(self, x) -> List[torch.Tensor]:
        outs = [x]
        for blk in self.down_blocks:
            outs.append(blk(outs[-1]))
        return outs


class Decoder(nn.Module):
    """Hourglass decoder with skip concatenation; output channels are
    block_expansion + in_features."""

    def __init__(self, block_expansion: int, in_features: int, num_blocks: int = 3,
                 max_features: int = 256, dtype=None):
        super().__init__()
        blocks = []
        for i in reversed(range(num_blocks)):
            cin = (1 if i == num_blocks - 1 else 2) * min(max_features,
                                                          block_expansion * 2 ** (i + 1))
            blocks.append(UpBlock2d(cin, min(max_features, block_expansion * 2 ** i),
                                    dtype=dtype))
        self.up_blocks = nn.ModuleList(blocks)
        self.out_filters = block_expansion + in_features

    def forward(self, skips: List[torch.Tensor]) -> torch.Tensor:
        skips = list(skips)
        out = skips.pop()
        for blk in self.up_blocks:
            out = torch.cat([blk(out), skips.pop()], dim=-1)
        return out


class Hourglass(nn.Module):
    """Encoder + decoder."""

    def __init__(self, block_expansion: int, in_features: int, num_blocks: int = 3,
                 max_features: int = 256, dtype=None):
        super().__init__()
        self.encoder = Encoder(block_expansion, in_features, num_blocks, max_features, dtype)
        self.decoder = Decoder(block_expansion, in_features, num_blocks, max_features, dtype)
        self.out_filters = self.decoder.out_filters

    def forward(self, x):
        return self.decoder(self.encoder(x))
