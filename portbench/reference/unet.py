"""Plain float32 3-D denoising UNet of ExtDM's ``w_ref_u22/ada_u22``
denoiser, channels-last (B, T, H, W, C).

Per level: two time-conditioned resnet blocks, a shifted and a plain 3-D
window attention layer (Swin3D windows, rotary q/k, a learned relative
position bias), a motion adaptor (the distribution extrapolation of the
cond frames' features into the prediction window) and attention over time
(T5 relative position bias). ``DenoiserBody`` holds the levels, the
middle and the output heads, which the conditioning families share; in
``Unet3D``, the adaptor family, the reference frame's features enter
through their own adaptor and temporal attention and the init conv, as a
term free of the noisy latents (``cond_term``). The trajwarp family is in
``reference/trajwarp.py``. Parameter names are the reference denoiser's
state-dict keys. Nothing here is imported from the program.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


# --- positions ----------------------------------------------------------------
def rotary(x: torch.Tensor, rot_dim: int = 32) -> torch.Tensor:
    """Rotary embedding along the sequence axis of (..., n, d) on the first
    min(rot_dim, d) features, dims (2i, 2i+1) rotated as a pair."""
    n, d = x.shape[-2], x.shape[-1]
    rot = min(rot_dim, d)
    inv_freq = 1.0 / (10000 ** (np.arange(0, rot, 2) / rot))
    ang = np.repeat(np.arange(n)[:, None] * inv_freq[None, :], 2, axis=-1)
    cos = torch.as_tensor(np.cos(ang), dtype=x.dtype, device=x.device)
    sin = torch.as_tensor(np.sin(ang), dtype=x.dtype, device=x.device)
    xr = x[..., :rot]
    swapped = torch.stack([-xr[..., 1::2], xr[..., 0::2]], dim=-1).reshape(xr.shape)
    out = xr * cos + swapped * sin
    return torch.cat([out, x[..., rot:]], dim=-1) if rot < d else out


def t5_buckets(n: int, num_buckets: int = 32, max_distance: int = 32) -> np.ndarray:
    """T5's bidirectional relative position buckets, (n, n)."""
    pos = np.arange(n)
    rel = pos[None, :] - pos[:, None]
    m = -rel
    half = num_buckets // 2
    ret = (m < 0).astype(np.int64) * half
    m = np.abs(m)
    exact = half // 2
    large = exact + (np.log(np.maximum(m, 1) / exact) / math.log(max_distance / exact)
                     * (half - exact)).astype(np.int64)
    return ret + np.where(m < exact, m, np.minimum(large, half - 1))


class RelativePositionBias(nn.Module):
    def __init__(self, heads: int, num_buckets: int = 32, max_distance: int = 32):
        super().__init__()
        self.num_buckets, self.max_distance = num_buckets, max_distance
        self.relative_attention_bias = nn.Embedding(num_buckets, heads)

    def forward(self, n: int) -> torch.Tensor:
        idx = torch.as_tensor(t5_buckets(n, self.num_buckets, self.max_distance),
                              device=self.relative_attention_bias.weight.device)
        return self.relative_attention_bias(idx).permute(2, 0, 1)  # (heads, n, n)


def clamp_window(size, window, shift):
    """Windows no larger than the volume; no shift along an axis it covers."""
    w, s = list(window), list(shift)
    for i, n in enumerate(size):
        if n <= window[i]:
            w[i], s[i] = n, 0
    return tuple(w), tuple(s)


def window_position_index(window) -> np.ndarray:
    """(N, N) index of each token pair's offset in the bias table."""
    wd, wh, ww = window
    c = np.stack(np.meshgrid(np.arange(wd), np.arange(wh), np.arange(ww), indexing="ij"))
    c = c.reshape(3, -1)
    rel = (c[:, :, None] - c[:, None, :]).transpose(1, 2, 0)
    rel += np.array([wd - 1, wh - 1, ww - 1])
    return rel[..., 0] * (2 * wh - 1) * (2 * ww - 1) + rel[..., 1] * (2 * ww - 1) + rel[..., 2]


def shift_mask(size, window, shift) -> np.ndarray:
    """(nW, N, N) additive mask of a rolled volume: -100 between tokens of
    different regions of the roll."""
    D, H, W = size
    label = np.zeros(size, np.int64)
    n = 0
    for d in (slice(0, -window[0]), slice(-window[0], -shift[0]), slice(-shift[0], None)):
        for h in (slice(0, -window[1]), slice(-window[1], -shift[1]), slice(-shift[1], None)):
            for w in (slice(0, -window[2]), slice(-window[2], -shift[2]), slice(-shift[2], None)):
                label[d, h, w] = n
                n += 1
    wd, wh, ww = window
    label = label.reshape(D // wd, wd, H // wh, wh, W // ww, ww).transpose(0, 2, 4, 1, 3, 5)
    label = label.reshape(-1, wd * wh * ww)
    return np.where(label[:, None, :] != label[:, :, None], -100.0, 0.0).astype(np.float32)


def chan_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over channels with a scale only (biased variance)."""
    return F.layer_norm(x, (x.shape[-1],), gamma.reshape(-1), None, eps)


def attend(q, k, v, bias, dim_head: int):
    """softmax(rope(q / sqrt(dh)) rope(k)^T + bias) v."""
    q, k = rotary(q * dim_head ** -0.5), rotary(k)
    return torch.softmax(q @ k.transpose(-1, -2) + bias, dim=-1) @ v


# --- modules ----------------------------------------------------------------------
class ChanLayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(1, dim, 1, 1, 1))

    def forward(self, x):
        return chan_norm(x, self.gamma)


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = ChanLayerNorm(dim)
        self.fn = fn

    def forward(self, x):
        return self.fn(self.norm(x))


class Residual(nn.Module):
    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return x + self.fn(x)


class PointwiseConv3d(nn.Conv3d):
    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 1)

    def forward(self, x):
        return F.linear(x, self.weight.flatten(1), self.bias)


class Conv3x3x3(nn.Conv3d):
    def __init__(self, dim: int):
        super().__init__(dim, dim, 3, padding=1, bias=False)

    def forward(self, x):
        return super().forward(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)


def conv_frames(x, weight, bias, stride=1, padding=0, transpose=False):
    """A (1, k, k) Conv3d (or its transpose) over (B, T, H, W, C)."""
    op = F.conv_transpose3d if transpose else F.conv3d
    y = op(x.permute(0, 4, 1, 2, 3), weight, bias, stride=(1, stride, stride),
           padding=(0, padding, padding))
    return y.permute(0, 2, 3, 4, 1)


class Extrapolator(nn.Module):
    """Normalise per (sample, channel) over (T, H, W) (unbiased variance),
    add a 3x3x3 conv, restore the statistics and append along T, doubling
    the frames per layer; returns only the new frames."""

    def __init__(self, dim: int, layers: int):
        super().__init__()
        self.predictor = Residual(PreNorm(dim, PointwiseConv3d(dim, dim)))
        self.extrapolators = nn.ModuleList(Residual(Conv3x3x3(dim)) for _ in range(layers))

    def forward(self, xm):
        tm = xm.shape[1]
        x = self.predictor(xm)
        for ext in self.extrapolators:
            mean = x.mean(dim=(1, 2, 3), keepdim=True)
            std = torch.sqrt(x.reshape(x.shape[0], -1, x.shape[-1]).var(dim=1, unbiased=True)
                             + 1e-5)[:, None, None, None, :]
            x = torch.cat([x, ext((x - mean) / std) * std + mean], dim=1)
        return x[:, tm:]


class MotionAdaptor(nn.Module):
    def __init__(self, dim: int, tc: int, tp: int):
        super().__init__()
        self.tc, self.tp = tc, tp
        layers = max(1, int(math.ceil(math.log2((tp + 1) / tc))))
        self.num_frames = (2 ** layers - 1) * tc
        self.adaptors = Extrapolator(dim, layers)
        self.Tmodulator = nn.Conv2d(self.num_frames * dim, tp * dim, 1)
        self.fuser = PreNorm(2 * dim, PointwiseConv3d(2 * dim, dim))

    def forward(self, x):
        B, T, H, W, C = x.shape
        xm, xp = x[:, :self.tc], x[:, self.tc:]
        ext = self.adaptors(xm)  # (B, nf, H, W, C): frame-major channels
        flat = ext.permute(0, 2, 3, 1, 4).reshape(B, H, W, self.num_frames * C)
        y = F.linear(flat, self.Tmodulator.weight.flatten(1), self.Tmodulator.bias)
        y = y.reshape(B, H, W, self.tp, C).permute(0, 3, 1, 2, 4)
        return torch.cat([xm, self.fuser(torch.cat([y, xp], dim=-1)) + xp], dim=1)


class Block3d(nn.Module):
    def __init__(self, dim: int, dim_out: int, groups: int):
        super().__init__()
        self.proj = nn.Conv3d(dim, dim_out, (1, 3, 3), padding=(0, 1, 1))
        self.norm = nn.GroupNorm(groups, dim_out, eps=1e-5)

    def forward(self, x, scale_shift=None):
        h = self.proj(x)
        h = self.norm(h)
        if scale_shift is not None:
            scale, shift = scale_shift
            h = h * (scale + 1) + shift
        return F.silu(h)


class ResnetBlock3d(nn.Module):
    def __init__(self, dim: int, dim_out: int, time_emb_dim: Optional[int], groups: int = 8):
        super().__init__()
        self.mlp = (nn.Sequential(nn.SiLU(), nn.Linear(time_emb_dim, dim_out * 2))
                    if time_emb_dim is not None else None)
        self.block1 = Block3d(dim, dim_out, groups)
        self.block2 = Block3d(dim_out, dim_out, groups)
        self.res_conv = nn.Conv3d(dim, dim_out, 1) if dim != dim_out else None

    def forward(self, x, time_emb=None):
        xc = x.permute(0, 4, 1, 2, 3)  # (B, C, T, H, W)
        scale_shift = None
        if self.mlp is not None and time_emb is not None:
            scale_shift = self.mlp(time_emb)[:, :, None, None, None].chunk(2, dim=1)
        h = self.block2(self.block1(xc, scale_shift))
        res = self.res_conv(xc) if self.res_conv is not None else xc
        return (h + res).permute(0, 2, 3, 4, 1)


class Downsample(nn.Conv3d):
    def __init__(self, dim: int):
        super().__init__(dim, dim, (1, 4, 4), (1, 2, 2), (0, 1, 1))

    def forward(self, x):
        return conv_frames(x, self.weight, self.bias, stride=2, padding=1)


class Upsample(nn.ConvTranspose3d):
    def __init__(self, dim: int):
        super().__init__(dim, dim, (1, 4, 4), (1, 2, 2), (0, 1, 1))

    def forward(self, x):
        return conv_frames(x, self.weight, self.bias, stride=2, padding=1, transpose=True)


class WindowAttention3D(nn.Module):
    def __init__(self, dim: int, window, heads: int, dim_head: int):
        super().__init__()
        wd, wh, ww = window
        self.window, self.heads, self.dim_head = tuple(window), heads, dim_head
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * wd - 1) * (2 * wh - 1) * (2 * ww - 1), heads))
        self.qkv = nn.Linear(dim, 3 * heads * dim_head, bias=False)
        self.proj = nn.Linear(heads * dim_head, dim)

    def forward(self, windows, N: int, mask=None):
        """(B, nW, N, C) windows -> (B, nW, N, C); mask (nW, N, N) or None."""
        B, nW = windows.shape[:2]
        idx = torch.as_tensor(window_position_index(self.window)[:N, :N],
                              device=windows.device)
        bias = self.relative_position_bias_table[idx].permute(2, 0, 1)  # (heads, N, N)
        bias = bias[None] if mask is None else bias[None] + mask[:, None]
        q, k, v = (a.reshape(B, nW, N, self.heads, self.dim_head).transpose(2, 3)
                   for a in self.qkv(windows).chunk(3, dim=-1))
        o = attend(q, k, v, bias, self.dim_head)
        return self.proj(o.transpose(2, 3).reshape(B, nW, N, -1))


class STWAttentionLayer(nn.Module):
    def __init__(self, dim: int, window, heads: int, dim_head: int):
        super().__init__()
        self.attn = WindowAttention3D(dim, window, heads, dim_head)


class PreNormSTW(nn.Module):
    """x + shifted-window attention of ChanLN(x) (Video Swin's layer)."""

    def __init__(self, dim: int, window, shift, heads: int, dim_head: int):
        super().__init__()
        self.window, self.shift = tuple(window), tuple(shift)
        self.fn = PreNorm(dim, STWAttentionLayer(dim, window, heads, dim_head))

    def forward(self, x):
        B, T, H, W, C = x.shape
        window, shift = clamp_window((T, H, W), self.window, self.shift)
        h = self.fn.norm(x)
        pads = [(w - n % w) % w for n, w in zip((T, H, W), window)]
        h = F.pad(h, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        Tp, Hp, Wp = h.shape[1:4]
        shifted = any(s > 0 for s in shift)
        mask = None
        if shifted:
            h = torch.roll(h, shifts=tuple(-s for s in shift), dims=(1, 2, 3))
            mask = torch.as_tensor(shift_mask((Tp, Hp, Wp), window, shift), device=x.device)
        wd, wh, ww = window
        N = wd * wh * ww
        win = h.reshape(B, Tp // wd, wd, Hp // wh, wh, Wp // ww, ww, C)
        win = win.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(B, -1, N, C)
        o = self.fn.fn.attn(win, N, mask)
        o = o.reshape(B, Tp // wd, Hp // wh, Wp // ww, wd, wh, ww, C)
        o = o.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(B, Tp, Hp, Wp, C)
        if shifted:
            o = torch.roll(o, shifts=shift, dims=(1, 2, 3))
        return x + o[:, :T, :H, :W]


class TemporalAttention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.to_qkv = nn.Linear(dim, 3 * heads * dim_head, bias=False)
        self.to_out = nn.Linear(heads * dim_head, dim, bias=False)


class TemporalAttentionLayer(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.attn = TemporalAttention(dim, heads, dim_head)


class _Rearranged(nn.Module):
    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn


class PreNormTemporalAttn(nn.Module):
    """x + h + attn(LN(h)) along T with h = ChanLN(x) (the reference's
    Residual(PreNorm(attention layer)) whose layer adds its input)."""

    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.fn = PreNorm(dim, _Rearranged(TemporalAttentionLayer(dim, heads, dim_head)))

    def forward(self, x, pos_bias):
        B, T, H, W, C = x.shape
        layer = self.fn.fn.fn
        h = self.fn.norm(x).permute(0, 2, 3, 1, 4).reshape(B, H * W, T, C)
        q, k, v = (a.reshape(B, H * W, T, self.heads, self.dim_head).transpose(2, 3)
                   for a in layer.attn.to_qkv(layer.norm(h)).chunk(3, dim=-1))
        o = attend(q, k, v, pos_bias, self.dim_head).transpose(2, 3).reshape(B, H * W, T, -1)
        h = h + layer.attn.to_out(o)
        return x + h.reshape(B, H, W, T, C).permute(0, 3, 1, 2, 4)


def time_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(torch.arange(half, device=t.device) * -(math.log(10000) / (half - 1)))
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([args.sin(), args.cos()], dim=-1)


class SinusoidalPosEmb(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t):
        return time_embedding(t, self.dim)


def resize_frames(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Bilinear resize (align_corners=False) of every frame of (B, T, h, w, C) to (H, W)."""
    B, T = x.shape[:2]
    y = F.interpolate(x.reshape(B * T, *x.shape[2:]).permute(0, 3, 1, 2), size=(H, W),
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1).reshape(B, T, H, W, -1)


class DenoiserBody(nn.Module):
    """What both conditioning families share after their init conv: the
    init temporal attention, the time MLP, the down levels, the middle, the
    up levels and the two output heads. A family registers its own init
    modules first and then calls ``_build_body``, so that the state dict
    keeps the reference denoiser's key order."""

    def _build_body(self, dim: int, dim_mults: Sequence[int], window_size: Tuple[int, int, int],
                    heads: int, dh: int, cond_num: int, pred_num: int, groups: int,
                    down_adaptor_from_level: int) -> None:
        shift = tuple(w // 2 for w in window_size)
        self.init_temporal_attn = PreNormTemporalAttn(dim, heads, dh)
        time_dim = dim * 4
        self.time_mlp = nn.Sequential(SinusoidalPosEmb(dim), nn.Linear(dim, time_dim),
                                      nn.GELU(approximate="tanh"), nn.Linear(time_dim, time_dim))
        dims = [dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        n = len(in_out)

        def level(d_in, d_out, adaptor, resample):
            return nn.ModuleList([
                ResnetBlock3d(d_in, d_out, time_dim, groups),
                PreNormSTW(d_out, window_size, shift, heads, dh),
                ResnetBlock3d(d_out, d_out, time_dim, groups),
                PreNormSTW(d_out, window_size, (0, 0, 0), heads, dh),
                MotionAdaptor(d_out, cond_num, pred_num) if adaptor else nn.Identity(),
                PreNormTemporalAttn(d_out, heads, dh),
                resample(d_out) if resample is not None else nn.Identity(),
            ])

        self.downs = nn.ModuleList(
            level(a, b, i >= down_adaptor_from_level, Downsample if i < n - 1 else None)
            for i, (a, b) in enumerate(in_out))
        mid = dims[-1]
        self.mid_block1 = ResnetBlock3d(mid, mid, time_dim, groups)
        self.mid_attn1 = PreNormSTW(mid, window_size, shift, heads, dh)
        self.mid_block2 = ResnetBlock3d(mid, mid, time_dim, groups)
        self.mid_attn2 = PreNormSTW(mid, window_size, (0, 0, 0), heads, dh)
        self.mid_adaptor = MotionAdaptor(mid, cond_num, pred_num)
        self.ups = nn.ModuleList(level(b * 2, a, i > 1, Upsample if i < n - 1 else None)
                                 for i, (a, b) in enumerate(reversed(in_out)))
        self.final_conv = nn.Sequential(ResnetBlock3d(dim * 2, dim, None, groups),
                                        PointwiseConv3d(dim, 2))
        self.occlusion_map = nn.Sequential(ResnetBlock3d(dim * 2, dim, None, groups),
                                           PointwiseConv3d(dim, 1))

    def _body(self, x: torch.Tensor, time: torch.Tensor, pos_bias: torch.Tensor) -> torch.Tensor:
        """The init conv's output x (B, tc + tp, h, w, dim) -> the predicted
        noise of the prediction frames (B, tp, h, w, 3)."""
        r = x
        x = self.init_temporal_attn(x, pos_bias)
        t = self.time_mlp(time)
        hs = []
        for res1, stw1, res2, stw2, adaptor, tattn, down in self.downs:
            x = res2(res1(x, t), t)
            x = tattn(adaptor(stw2(stw1(x))), pos_bias)
            hs.append(x)
            x = down(x)
        x = self.mid_block1(x, t)
        x = self.mid_adaptor(self.mid_attn2(self.mid_attn1(x)))
        x = self.mid_block2(x, t)
        for res1, stw1, res2, stw2, adaptor, tattn, up in self.ups:
            x = torch.cat([x, hs.pop()], dim=-1)
            x = res2(res1(x, t), t)
            x = tattn(adaptor(stw2(stw1(x))), pos_bias)
            x = up(x)
        x = torch.cat([x, r], dim=-1)
        out = torch.cat([proj(block(x)) for block, proj in (self.final_conv, self.occlusion_map)],
                        dim=-1)
        return out[:, self.tc:]


class Unet3D(DenoiserBody):
    """The adaptor-conditioned denoiser with reference-frame features."""

    def __init__(self, dim: int, dim_mults: Sequence[int], window_size: Tuple[int, int, int],
                 attn_heads: int, attn_dim_head: int, cond_num: int, pred_num: int,
                 cond_feature_dim: int, channels: int = 3, init_kernel_size: int = 7,
                 groups: int = 8, down_adaptor_from_level: int = 0):
        super().__init__()
        self.channels, self.tc, self.tp = channels, cond_num, pred_num
        heads, dh = attn_heads, attn_dim_head
        self.init_pad = init_kernel_size // 2
        k0 = init_kernel_size
        self.time_rel_pos_bias = RelativePositionBias(heads)
        self.init_conv = nn.Conv3d(channels + cond_feature_dim, dim, (1, k0, k0),
                                   padding=(0, k0 // 2, k0 // 2))
        self.cond_adaptor = MotionAdaptor(cond_feature_dim, cond_num, pred_num)
        self.cond_temporal_attn = PreNormTemporalAttn(cond_feature_dim, heads, dh)
        self._build_body(dim, dim_mults, window_size, heads, dh, cond_num, pred_num, groups,
                         down_adaptor_from_level)

    def cond_term(self, cond_fea: torch.Tensor, H: int, W: int) -> torch.Tensor:
        """The conditioning that the init conv adds from the features: it
        depends on neither the noisy latents nor the time."""
        pos_bias = self.time_rel_pos_bias(cond_fea.shape[1])
        cf = self.cond_temporal_attn(self.cond_adaptor(cond_fea), pos_bias)
        return conv_frames(resize_frames(cf, H, W), self.init_conv.weight[:, self.channels:], None,
                           padding=self.init_pad)

    def forward(self, x, time, cond_frames, cond_fea=None, cond_term=None):
        """x (B, tp, h, w, 3) noisy latents, cond_frames (B, tc, h, w, 3),
        cond_fea (B, tc + tp, hf, wf, Cf) -> predicted noise (B, tp, h, w, 3)."""
        x = torch.cat([cond_frames, x], dim=1)
        B, T, H, W, _ = x.shape
        pos_bias = self.time_rel_pos_bias(T)
        if cond_term is None:
            cond_term = self.cond_term(cond_fea, H, W)
        x = conv_frames(x, self.init_conv.weight[:, :self.channels], self.init_conv.bias,
                        padding=self.init_pad) + cond_term
        return self._body(x, time, pos_bias)
