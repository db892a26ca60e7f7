"""Plain float32 denoiser of ExtDM's trajwarp family (the ``w_ref/traj``
denoisers, ``DenoiseNet_STWAtt_w_w_ref_adaptor_cross_multi_traj_u22``),
channels-last (B, T, H, W, C).

The init path lifts the noisy latents to the features' width and warps
the reference features toward them at every call, so nothing of it is
free of x:

1. the noise conv, (1, 7, 7), lifts the 3-channel latents of all frames to
   the features' width Cf;
2. ``TrajWarp``: the lifted prediction frames, max-pooled 2x2 to the
   features' size, are the queries (ReLU'd linear q) of a cross-attention
   onto the cond frames' feature tokens (ReLU'd linear k and v), ``heads``
   heads of Cf / heads; its ReLU'd output projection and the prediction
   frames' features go through a 1x1x1 fuser; the cond frames' features
   pass unchanged;
3. a bilinear 2x resize of the result to the latents' size;
4. the init conv, (1, 7, 7), over [lifted, warped], 2 Cf -> dim.

The body after the init conv is the adaptor family's
(``reference/unet.py``): window and shift from ``window_size``,
MotionAdaptors on the down levels from ``down_adaptor_from_level``, on the
up levels past the first two and in the middle; this family has no
``cond_adaptor``. Parameter names are the reference denoiser's state-dict
keys. Nothing here is imported from the program.

Departures from the published module (``TrajWarp``, whose attention is a
``MultiHeadAttentionOp``): the products of the attention are written out
(scores, then values) so that ``FlopCounterMode`` counts them, with the
scores divided by sqrt(Cf / heads) after their product and the softmax
taken in float32, as the written-down equations of the JAX package's
``TrajWarp`` have them; the queries are max-pooled 2x2 and the warped
features resized bilinearly (align_corners=False) to the latents, as there.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.unet import (DenoiserBody, PointwiseConv3d, RelativePositionBias,
                                      conv_frames, resize_frames)


class TrajWarp(nn.Module):
    def __init__(self, dim: int, tc: int, tp: int, heads: int):
        super().__init__()
        self.tc, self.tp, self.heads = tc, tp, heads
        self.linear_q, self.linear_k = nn.Linear(dim, dim), nn.Linear(dim, dim)
        self.linear_v, self.linear_o = nn.Linear(dim, dim), nn.Linear(dim, dim)
        self.fuser = PointwiseConv3d(2 * dim, dim)

    def forward(self, xp: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        """xp (B, tp, 2H, 2W, C) the lifted prediction frames, f (B, tc + tp,
        H, W, C) the features -> the warped features, f's shape."""
        B, T, H, W, C = f.shape
        fm, fp = f[:, :self.tc], f[:, self.tc:]
        pooled = F.max_pool2d(xp.reshape(B * self.tp, *xp.shape[2:]).permute(0, 3, 1, 2), 2, 2)
        if tuple(pooled.shape[2:]) != (H, W):
            raise ValueError(f"pooled queries {tuple(pooled.shape[2:])} != features {(H, W)}")
        d = C // self.heads

        def heads(lin, a):
            return F.relu(lin(a)).reshape(B, -1, self.heads, d).transpose(1, 2)

        q = heads(self.linear_q, pooled.permute(0, 2, 3, 1).reshape(B, -1, C))
        kv = fm.reshape(B, -1, C)
        k, v = heads(self.linear_k, kv), heads(self.linear_v, kv)
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(d)
        attn = torch.softmax(scores.float(), dim=-1).to(v.dtype)
        out = (attn @ v).transpose(1, 2).reshape(B, -1, C)
        warped = F.relu(self.linear_o(out)).reshape(B, self.tp, H, W, C)
        return torch.cat([fm, self.fuser(torch.cat([fp, warped], dim=-1))], dim=1)


class TrajUnet3D(DenoiserBody):
    """The trajwarp-conditioned denoiser with reference-frame features."""

    def __init__(self, dim: int, dim_mults: Sequence[int], window_size: Tuple[int, int, int],
                 attn_heads: int, attn_dim_head: int, cond_num: int, pred_num: int,
                 cond_feature_dim: int, channels: int = 3, init_kernel_size: int = 7,
                 groups: int = 8, down_adaptor_from_level: int = 0):
        super().__init__()
        self.channels, self.tc, self.tp = channels, cond_num, pred_num
        k0, cf = init_kernel_size, cond_feature_dim
        self.init_pad = k0 // 2
        self.time_rel_pos_bias = RelativePositionBias(attn_heads)
        self.init_noise_conv = nn.Conv3d(channels, cf, (1, k0, k0), padding=(0, k0 // 2, k0 // 2))
        self.init_traj = TrajWarp(cf, cond_num, pred_num, attn_heads)
        self.init_conv = nn.Conv3d(2 * cf, dim, (1, k0, k0), padding=(0, k0 // 2, k0 // 2))
        self._build_body(dim, dim_mults, window_size, attn_heads, attn_dim_head, cond_num,
                         pred_num, groups, down_adaptor_from_level)

    def cond_term(self, cond_fea: torch.Tensor, H: int, W: int) -> torch.Tensor:
        """The conditioning free of x: in this family the features
        themselves, warped at every call."""
        return cond_fea

    def forward(self, x, time, cond_frames, cond_fea=None, cond_term=None):
        """x (B, tp, h, w, 3) noisy latents, cond_frames (B, tc, h, w, 3),
        cond_fea or cond_term (B, tc + tp, h / 2, w / 2, Cf) -> predicted
        noise (B, tp, h, w, 3)."""
        fea = cond_fea if cond_term is None else cond_term
        x = torch.cat([cond_frames, x], dim=1)
        H, W = x.shape[2:4]
        pos_bias = self.time_rel_pos_bias(x.shape[1])
        nc = self.init_noise_conv
        x = conv_frames(x, nc.weight, nc.bias, padding=self.init_pad)
        warped = resize_frames(self.init_traj(x[:, self.tc:], fea), H, W)
        x = conv_frames(torch.cat([x, warped], dim=-1), self.init_conv.weight,
                        self.init_conv.bias, padding=self.init_pad)
        return self._body(x, time, pos_bias)
