"""3-D diffusion UNet over the flow + occlusion latents (port of
extdm_tpu/models/dm/unet3d.py), the ``adaptor`` conditioning family.

Per level: two time-conditioned ResnetBlock3d, a shifted and a plain window
attention layer, a MotionAdaptor and a temporal attention layer. On the card
the resnet blocks and both attention layers run as this package's CUDA
kernels (``ops/fused_*.py``); on the CPU as their plain versions.
Parameter names follow the reference denoiser's state dict
(``downs.{i}.{0..6}``, ``mid_block1``, ``final_conv.0``, ...), so
``convert.py`` maps the JAX variables onto them. Layout (B, T, H, W, C).

Dtype policy, as in the flax modules: ``dtype`` is the compute type (None:
float32); parameters keep their own type (float32 master weights when
training) and each layer casts them to the compute type where it uses them.
The time MLP runs in float32 and norm statistics stay float32. With
``remat``, the MotionAdaptors run under ``torch.utils.checkpoint``: their
autograd would keep every intermediate of the extrapolator, while the
kernel layers' autograd Functions already keep only their inputs.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from extdm_tpu_torch.models.dm.adaptor import MotionAdaptor, PointwiseConv3d, PreNorm, cast
from extdm_tpu_torch.nn.attention import (RelativePositionBias, RelativePositionBiasTHW,
                                          TemporalAttentionLayer, WindowAttention3D,
                                          get_window_size)
from extdm_tpu_torch.ops.fused_resnet import fused_resnet_block
from extdm_tpu_torch.ops.fused_stw import (WINDOW_MAJOR_MODES, fused_stw_layer,
                                           fused_temporal_layer)
from extdm_tpu_torch.ops.resize import interpolate_bilinear


def sinusoidal_pos_emb(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(torch.arange(half, device=t.device) * -(math.log(10000) / (half - 1)))
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([args.sin(), args.cos()], dim=-1)


class SinusoidalPosEmb(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t):
        return sinusoidal_pos_emb(t, self.dim)


def conv_frames(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], dtype,
                stride: int = 1, padding: int = 0, transpose: bool = False) -> torch.Tensor:
    """A (1, k, k) Conv3d (or ConvTranspose3d) applied frame by frame to
    (B, T, H, W, C), computing in `dtype`."""
    B, T, H, W, C = x.shape
    xf = x.to(dtype).reshape(B * T, H, W, C).permute(0, 3, 1, 2)
    op = F.conv_transpose2d if transpose else F.conv2d
    y = op(xf, weight.squeeze(2).to(dtype), cast(bias, dtype), stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1).reshape(B, T, *y.shape[2:], y.shape[1])


class Block3d(nn.Module):
    """conv (1,3,3) + GroupNorm parameters of one half of a ResnetBlock3d."""

    def __init__(self, dim: int, dim_out: int, groups: int = 8):
        super().__init__()
        self.proj = nn.Conv3d(dim, dim_out, (1, 3, 3), padding=(0, 1, 1))
        self.norm = nn.GroupNorm(groups, dim_out, eps=1e-5)


class ResnetBlock3d(nn.Module):
    """Two Block3d with FiLM time conditioning and a residual; runs as
    ``fused_resnet_block``."""

    def __init__(self, dim: int, dim_out: int, time_emb_dim: Optional[int] = None,
                 groups: int = 8, dtype=None):
        super().__init__()
        self.groups = groups
        self.compute_dtype = dtype or torch.float32
        self.mlp = (nn.Sequential(nn.SiLU(), nn.Linear(time_emb_dim, dim_out * 2))
                    if time_emb_dim is not None else None)
        self.block1 = Block3d(dim, dim_out, groups)
        self.block2 = Block3d(dim_out, dim_out, groups)
        self.res_conv = nn.Conv3d(dim, dim_out, 1) if dim != dim_out else None

    def forward(self, x, time_emb=None):
        film = None
        dt = self.compute_dtype
        if self.mlp is not None and time_emb is not None:
            lin = self.mlp[1]
            film = F.linear(self.mlp[0](time_emb.to(dt)), lin.weight.to(dt), lin.bias.to(dt))
        b1, b2, rc = self.block1, self.block2, self.res_conv
        return fused_resnet_block(
            x.to(dt), b1.proj.weight, b1.proj.bias, b1.norm.weight, b1.norm.bias, film,
            b2.proj.weight, b2.proj.bias, b2.norm.weight, b2.norm.bias,
            rc.weight if rc is not None else None, rc.bias if rc is not None else None,
            groups=self.groups)


class Downsample(nn.Conv3d):
    """conv (1,4,4) stride (1,2,2)."""

    def __init__(self, dim: int, dtype=None):
        super().__init__(dim, dim, (1, 4, 4), (1, 2, 2), (0, 1, 1))
        self.compute_dtype = dtype or torch.float32

    def forward(self, x):
        return conv_frames(x, self.weight, self.bias, self.compute_dtype, stride=2, padding=1)


class Upsample(nn.ConvTranspose3d):
    """transposed conv (1,4,4) stride (1,2,2): doubles H and W."""

    def __init__(self, dim: int, dtype=None):
        super().__init__(dim, dim, (1, 4, 4), (1, 2, 2), (0, 1, 1))
        self.compute_dtype = dtype or torch.float32

    def forward(self, x):
        return conv_frames(x, self.weight, self.bias, self.compute_dtype, stride=2, padding=1,
                           transpose=True)


class STWAttentionLayer(nn.Module):
    """Holds the window attention parameters (reference STWAttentionLayer)."""

    def __init__(self, dim: int, window_size, heads: int, dim_head: int):
        super().__init__()
        self.attn = WindowAttention3D(dim, window_size, heads, dim_head)


class PreNormSTW(nn.Module):
    """Residual(PreNorm(STWAttentionLayer)); runs as ``fused_stw_layer``."""

    def __init__(self, dim: int, window_size: Tuple[int, int, int],
                 shift_size: Tuple[int, int, int], heads: int, dim_head: int,
                 window_major: str = "0"):
        super().__init__()
        self.window_size, self.shift_size = tuple(window_size), tuple(shift_size)
        self.heads, self.dim_head, self.window_major = heads, dim_head, window_major
        self.fn = PreNorm(dim, STWAttentionLayer(dim, window_size, heads, dim_head))

    def forward(self, x):
        window, shift = get_window_size(x.shape[1:4], self.window_size, self.shift_size)
        attn = self.fn.fn.attn
        bias = attn.bias_hnn(window[0] * window[1] * window[2])
        return fused_stw_layer(x, self.fn.norm.gamma.reshape(-1), attn.qkv.weight,
                               attn.proj.weight, attn.proj.bias, bias, window=window,
                               shift=shift, heads=self.heads, dim_head=self.dim_head,
                               window_major=self.window_major)


class _Rearranged(nn.Module):
    """Holds `fn` where the reference wraps it in EinopsToAndFrom."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn


class PreNormTemporalAttn(nn.Module):
    """Residual(PreNorm(EinopsToAndFrom(AttentionLayer))) over T; runs as
    ``fused_temporal_layer``."""

    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.fn = PreNorm(dim, _Rearranged(TemporalAttentionLayer(dim, heads, dim_head)))

    def forward(self, x, pos_bias=None):
        T = x.shape[1]
        layer = self.fn.fn.fn
        if pos_bias is None:
            bias = torch.zeros(self.heads, T, T, device=x.device)
        elif pos_bias.ndim == 4:  # THW bias: reduced per query, broadcast over keys
            bias = pos_bias.mean(dim=(-2, -1))[:, :, None].expand(self.heads, T, T)
        else:
            bias = pos_bias
        return fused_temporal_layer(x, self.fn.norm.gamma.reshape(-1), layer.norm.weight,
                                    layer.norm.bias, layer.attn.to_qkv.weight,
                                    layer.attn.to_out.weight, bias, heads=self.heads,
                                    dim_head=self.dim_head)


class Unet3D(nn.Module):
    def __init__(self, dim: int = 64, out_grid_dim: int = 2, out_conf_dim: int = 1,
                 window_size: Tuple[int, int, int] = (4, 4, 4),
                 dim_mults: Sequence[int] = (1, 2, 4, 4), channels: int = 3,
                 cond_feature_dim: int = 256, attn_heads: int = 8, attn_dim_head: int = 32,
                 init_kernel_size: int = 7, resnet_groups: int = 8, cond_num: int = 0,
                 pred_num: int = 0, use_ref_features: bool = True,
                 conditioning: str = "adaptor", down_adaptor_from_level: int = 0,
                 path: int = 0, remat: bool = True, dtype=None, stw_window_major: str = "0"):
        super().__init__()
        if conditioning not in ("adaptor", "none"):
            raise NotImplementedError(f"conditioning={conditioning!r} is not ported yet")
        if stw_window_major not in WINDOW_MAJOR_MODES:
            raise ValueError(f"stw_window_major is one of {WINDOW_MAJOR_MODES}, "
                             f"got {stw_window_major!r}")
        wm = stw_window_major
        self.channels, self.path, self.remat = channels, path, remat
        self.compute_dtype = dt = dtype or torch.float32
        self.cond_num, self.pred_num = cond_num, pred_num
        self.use_ref_features = use_ref_features
        heads, dh = attn_heads, attn_dim_head
        shift = tuple(w // 2 for w in window_size)
        init_dim, k0 = dim, init_kernel_size
        self.init_pad = k0 // 2

        if path == 1:
            self.rel_pos_bias_thw = RelativePositionBiasTHW(heads=heads, max_distance=32)
            self.alpha = nn.Parameter(torch.ones(heads))
            self.beta = nn.Parameter(torch.ones(heads))
        else:
            self.time_rel_pos_bias = RelativePositionBias(heads=heads, max_distance=32)

        in_ch = channels + (cond_feature_dim if use_ref_features else 0)
        self.init_conv = nn.Conv3d(in_ch, init_dim, (1, k0, k0), padding=(0, k0 // 2, k0 // 2))
        if use_ref_features:
            self.cond_adaptor = MotionAdaptor(cond_feature_dim, cond_num, pred_num, dt)
            self.cond_temporal_attn = PreNormTemporalAttn(cond_feature_dim, heads, dh)
        self.init_temporal_attn = PreNormTemporalAttn(init_dim, heads, dh)

        time_dim = dim * 4
        self.time_mlp = nn.Sequential(SinusoidalPosEmb(dim), nn.Linear(dim, time_dim),
                                      nn.GELU(approximate="tanh"), nn.Linear(time_dim, time_dim))

        dims = [init_dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        n = len(in_out)

        def level(d_in, d_out, adaptor, resample):
            return nn.ModuleList([
                ResnetBlock3d(d_in, d_out, time_dim, resnet_groups, dt),
                PreNormSTW(d_out, window_size, shift, heads, dh, wm),
                ResnetBlock3d(d_out, d_out, time_dim, resnet_groups, dt),
                PreNormSTW(d_out, window_size, (0, 0, 0), heads, dh, wm),
                MotionAdaptor(d_out, cond_num, pred_num, dt) if adaptor else nn.Identity(),
                PreNormTemporalAttn(d_out, heads, dh),
                resample(d_out, dt) if resample is not None else nn.Identity(),
            ])

        ada = conditioning == "adaptor"
        self.downs = nn.ModuleList(
            level(d_in, d_out, ada and i >= down_adaptor_from_level,
                  Downsample if i < n - 1 else None)
            for i, (d_in, d_out) in enumerate(in_out))
        mid = dims[-1]
        self.mid_block1 = ResnetBlock3d(mid, mid, time_dim, resnet_groups, dt)
        self.mid_attn1 = PreNormSTW(mid, window_size, shift, heads, dh, wm)
        self.mid_block2 = ResnetBlock3d(mid, mid, time_dim, resnet_groups, dt)
        self.mid_attn2 = PreNormSTW(mid, window_size, (0, 0, 0), heads, dh, wm)
        self.mid_adaptor = MotionAdaptor(mid, cond_num, pred_num, dt) if ada else nn.Identity()
        self.ups = nn.ModuleList(
            level(d_out * 2, d_in, ada and i > 1, Upsample if i < n - 1 else None)
            for i, (d_in, d_out) in enumerate(reversed(in_out)))
        self.final_conv = nn.Sequential(ResnetBlock3d(dim * 2, dim, None, resnet_groups, dt),
                                        PointwiseConv3d(dim, out_grid_dim, dtype=dt))
        self.occlusion_map = nn.Sequential(ResnetBlock3d(dim * 2, dim, None, resnet_groups, dt),
                                           PointwiseConv3d(dim, out_conf_dim, dtype=dt))

    def _pos_bias(self, T: int, H: int, W: int) -> torch.Tensor:
        if self.path != 1:
            return self.time_rel_pos_bias(T)
        t_bias, h_bias, w_bias = self.rel_pos_bias_thw(T, H, W)
        heads = t_bias.shape[0]

        def resize(b):
            return interpolate_bilinear(b[..., None], (T, T))[..., 0]

        hb = resize(h_bias)[:, None, :, :]
        wb = resize(w_bias)[:, :, None, :]
        tb = t_bias[:, :, None, :]
        full = (heads, T, T, T)
        return (self.alpha[:, None, None, None] * tb.expand(full)
                + self.beta[:, None, None, None] * (hb.expand(full) + wb.expand(full)))

    def _adapt(self, adaptor: nn.Module, x: torch.Tensor) -> torch.Tensor:
        if self.remat and isinstance(adaptor, MotionAdaptor) and torch.is_grad_enabled():
            return checkpoint(adaptor, x, use_reentrant=False)
        return adaptor(x)

    def cond_stream(self, cond_fea: torch.Tensor, H: int, W: int,
                    pos_bias: torch.Tensor) -> torch.Tensor:
        """The (x, t)-invariant conditioning term added after the init conv."""
        B, T = cond_fea.shape[:2]
        cf = self._adapt(self.cond_adaptor, cond_fea.to(self.compute_dtype))
        cf = self.cond_temporal_attn(cf, pos_bias)
        cf = interpolate_bilinear(cf.reshape(B * T, *cf.shape[2:]), (H, W))
        cf = cf.reshape(B, T, H, W, -1)
        return conv_frames(cf, self.init_conv.weight[:, self.channels:], None, self.compute_dtype,
                           padding=self.init_pad)

    def forward(self, x, time, cond_frames, cond_fea=None, cond_cache=None,
                cond_only: bool = False):
        """x (B, tp, h, w, C) noisy latents, cond_frames (B, tc, h, w, C),
        cond_fea (B, tc+tp, hf, wf, cond_feature_dim) -> (B, tp, h, w, 3) float32.
        cond_only returns the conditioning term to pass back as cond_cache."""
        tc, tp = cond_frames.shape[1], x.shape[1]
        if (tc, tp) != (self.cond_num, self.pred_num):
            raise ValueError(f"frames (cond, pred) = {(tc, tp)}, the UNet was built for "
                             f"{(self.cond_num, self.pred_num)}")
        dtype = self.compute_dtype
        x = torch.cat([cond_frames, x], dim=1).to(dtype)
        B, T, H, W, _ = x.shape
        pos_bias = self._pos_bias(T, H, W)

        w0, b0 = self.init_conv.weight, self.init_conv.bias
        if self.use_ref_features:
            if cond_cache is None:
                cond_cache = self.cond_stream(cond_fea, H, W, pos_bias)
            if cond_only:
                return cond_cache
            x = conv_frames(x, w0[:, :self.channels], b0, dtype, padding=self.init_pad) + cond_cache
        else:
            x = conv_frames(x, w0, b0, dtype, padding=self.init_pad)

        r = x
        x = self.init_temporal_attn(x, pos_bias)

        tm = self.time_mlp
        t_emb = F.linear(tm[0](time), tm[1].weight.float(), tm[1].bias.float())
        t_emb = F.linear(tm[2](t_emb), tm[3].weight.float(), tm[3].bias.float())

        hs = []
        for res1, stw1, res2, stw2, adaptor, tattn, down in self.downs:
            x = res2(res1(x, t_emb), t_emb)
            x = self._adapt(adaptor, stw2(stw1(x)))
            x = tattn(x, pos_bias)
            hs.append(x)
            x = down(x)
        x = self.mid_block1(x, t_emb)
        x = self._adapt(self.mid_adaptor, self.mid_attn2(self.mid_attn1(x)))
        x = self.mid_block2(x, t_emb)
        for res1, stw1, res2, stw2, adaptor, tattn, up in self.ups:
            x = torch.cat([x, hs.pop()], dim=-1)
            x = res2(res1(x, t_emb), t_emb)
            x = self._adapt(adaptor, stw2(stw1(x)))
            x = tattn(x, pos_bias)
            x = up(x)
        x = torch.cat([x, r], dim=-1)
        out = torch.cat([self.final_conv(x), self.occlusion_map(x)], dim=-1)
        return out[:, tc:].float()
