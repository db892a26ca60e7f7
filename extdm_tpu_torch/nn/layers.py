"""LFAE building blocks (port of extdm_tpu/nn/layers.py), channels-last.

Convolutions and BatchNorm take (B, H, W, C) tensors and keep PyTorch's
parameter layouts and the reference LFAE's state-dict names. These convs
sit outside every TPU kernel of the JAX package, so they stay cuDNN
convolutions here.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from extdm_tpu_torch.ops.resize import avg_pool_2x2, upsample_nearest


def chan_layer_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last (channel) axis with a scale only and biased
    variance; float32 statistics, output in x.dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps) * gamma.float().reshape(-1)).to(x.dtype)


class Conv2d(nn.Conv2d):
    """nn.Conv2d on channels-last (B, H, W, C) tensors, computing in its
    parameters' dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.weight.dtype).permute(0, 3, 1, 2)
        return super().forward(x).permute(0, 2, 3, 1)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d on (B, H, W, C) tensors with flax's statistics update.

    In eval mode (the LFAE frozen inside the diffusion model) it normalizes
    with the running statistics. In train mode (stage-1 training) it
    normalizes with the batch's and moves the running statistics by
    ``momentum`` toward the batch mean and the *biased* batch variance, as
    flax ``nn.BatchNorm(momentum=0.9)`` does; ``F.batch_norm`` would move
    them toward the unbiased variance."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.weight.dtype).permute(0, 3, 1, 2)
        if not self.training:
            y = F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                             False, 0.0, self.eps)
            return y.permute(0, 2, 3, 1)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
            self.running_mean.lerp_(mean.to(self.running_mean.dtype), self.momentum)
            self.running_var.lerp_(var.to(self.running_var.dtype), self.momentum)
        # no running statistics here: autograd would keep them for the
        # backward, and the module's next call in this step updates them
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        return y.permute(0, 2, 3, 1)


class SameBlock2d(nn.Module):
    """conv -> BN -> ReLU, same resolution."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel_size, padding=kernel_size // 2)
        self.norm = BatchNorm(cout)

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

    def __init__(self, features: int, kernel_size: int = 3):
        super().__init__()
        pad = kernel_size // 2
        self.norm1 = BatchNorm(features)
        self.conv1 = Conv2d(features, features, kernel_size, padding=pad)
        self.norm2 = BatchNorm(features)
        self.conv2 = Conv2d(features, features, kernel_size, padding=pad)

    def forward(self, x):
        h = self.conv1(F.relu(self.norm1(x)))
        return self.conv2(F.relu(self.norm2(h))) + x


class Encoder(nn.Module):
    """Hourglass encoder; returns [input, d1, ..., dN]."""

    def __init__(self, block_expansion: int, in_features: int, num_blocks: int = 3,
                 max_features: int = 256):
        super().__init__()
        chans = [in_features] + [min(max_features, block_expansion * 2 ** (i + 1))
                                 for i in range(num_blocks)]
        self.down_blocks = nn.ModuleList(DownBlock2d(chans[i], chans[i + 1])
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
                 max_features: int = 256):
        super().__init__()
        blocks = []
        for i in reversed(range(num_blocks)):
            cin = (1 if i == num_blocks - 1 else 2) * min(max_features,
                                                          block_expansion * 2 ** (i + 1))
            blocks.append(UpBlock2d(cin, min(max_features, block_expansion * 2 ** i)))
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
                 max_features: int = 256):
        super().__init__()
        self.encoder = Encoder(block_expansion, in_features, num_blocks, max_features)
        self.decoder = Decoder(block_expansion, in_features, num_blocks, max_features)
        self.out_filters = self.decoder.out_filters

    def forward(self, x):
        return self.decoder(self.encoder(x))
