"""Attention pieces of the diffusion UNet (port of extdm_tpu/nn/attention.py).

Rotary embedding, T5 relative position biases, the 3-D window helpers, the
parameter modules of the window and temporal attention, and their plain
forward math as functions (``window_attention``, ``temporal_attention``).
The whole-layer kernels in ``ops/fused_stw.py`` replace these functions on
the card; on the CPU the layers run them. Layouts are channels-last.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn


# --- rotary -------------------------------------------------------------------
def rotary_tables(n: int, rot_dim: int) -> Tuple[np.ndarray, np.ndarray]:
    """cos/sin tables (n, rot_dim), interleaved pair layout, float32."""
    inv_freq = 1.0 / (10000 ** (np.arange(0, rot_dim, 2) / rot_dim))
    freqs = np.repeat(np.einsum("i,j->ij", np.arange(n), inv_freq), 2, axis=-1)
    return np.cos(freqs).astype(np.float32), np.sin(freqs).astype(np.float32)


def _rotate_half_interleaved(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape)


def apply_rotary(x: torch.Tensor, rot_dim: int) -> torch.Tensor:
    """Rotary embedding along the sequence axis of (..., n, d) on the first
    min(rot_dim, d) features (rotary_embedding_torch semantics)."""
    n, d = x.shape[-2], x.shape[-1]
    rot = min(rot_dim, d)
    cos, sin = (torch.as_tensor(t, dtype=x.dtype, device=x.device) for t in rotary_tables(n, rot))
    x_rot = x[..., :rot] * cos + _rotate_half_interleaved(x[..., :rot]) * sin
    return torch.cat([x_rot, x[..., rot:]], dim=-1) if rot < d else x_rot


# --- T5 relative position bias --------------------------------------------------
def _relative_position_bucket(rel_pos: np.ndarray, num_buckets: int = 32,
                              max_distance: int = 128) -> np.ndarray:
    ret = np.zeros_like(rel_pos)
    n = -rel_pos
    num_buckets //= 2
    ret += (n < 0).astype(np.int64) * num_buckets
    n = np.abs(n)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        np.log(np.maximum(n, 1).astype(np.float64) / max_exact)
        / math.log(max_distance / max_exact) * (num_buckets - max_exact)
    ).astype(np.int64)
    val_if_large = np.minimum(val_if_large, num_buckets - 1)
    return ret + np.where(is_small, n, val_if_large)


@lru_cache(maxsize=None)
def _rel_bucket_matrix(n: int, num_buckets: int, max_distance: int) -> np.ndarray:
    pos = np.arange(n)
    return _relative_position_bucket(pos[None, :] - pos[:, None], num_buckets, max_distance)


class RelativePositionBias(nn.Module):
    """bias(n) -> (heads, n, n) from a learned bucket table."""

    def __init__(self, heads: int = 8, num_buckets: int = 32, max_distance: int = 128):
        super().__init__()
        self.num_buckets, self.max_distance = num_buckets, max_distance
        self.relative_attention_bias = nn.Embedding(num_buckets, heads)

    def bias(self, n: int) -> torch.Tensor:
        table = self.relative_attention_bias.weight
        buckets = torch.as_tensor(_rel_bucket_matrix(n, self.num_buckets, self.max_distance),
                                  device=table.device)
        return table[buckets].permute(2, 0, 1)

    def forward(self, n: int) -> torch.Tensor:
        return self.bias(n)


class RelativePositionBiasTHW(RelativePositionBias):
    """Per-axis T/H/W biases sharing one bucket table: three (heads, n, n)."""

    def forward(self, t: int, h: int, w: int):
        return self.bias(t), self.bias(h), self.bias(w)


# --- windows ------------------------------------------------------------------------
def get_window_size(x_size: Sequence[int], window_size: Sequence[int],
                    shift_size: Optional[Sequence[int]] = None):
    """Clamp the window to the tensor size; zero the shift where clamped."""
    ws = list(window_size)
    ss = list(shift_size) if shift_size is not None else None
    for i, s in enumerate(x_size):
        if s <= window_size[i]:
            ws[i] = s
            if ss is not None:
                ss[i] = 0
    return (tuple(ws), tuple(ss)) if ss is not None else tuple(ws)


def window_partition(x: torch.Tensor, window: Tuple[int, int, int]) -> torch.Tensor:
    """(B, D, H, W, C) -> (B*nW, wd*wh*ww, C)."""
    B, D, H, W, C = x.shape
    wd, wh, ww = window
    x = x.reshape(B, D // wd, wd, H // wh, wh, W // ww, ww, C)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, wd * wh * ww, C)


def window_reverse(windows: torch.Tensor, window: Tuple[int, int, int], B: int, D: int,
                   H: int, W: int) -> torch.Tensor:
    wd, wh, ww = window
    x = windows.reshape(B, D // wd, H // wh, W // ww, wd, wh, ww, -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(B, D, H, W, -1)


@lru_cache(maxsize=None)
def shifted_window_mask(D: int, H: int, W: int, window: Tuple[int, int, int],
                        shift: Tuple[int, int, int]) -> np.ndarray:
    """(nW, N, N) additive Swin mask, 0 within a region and -100 across."""
    img = np.zeros((D, H, W), dtype=np.int32)
    cnt = 0
    for d in (slice(0, -window[0]), slice(-window[0], -shift[0]), slice(-shift[0], None)):
        for h in (slice(0, -window[1]), slice(-window[1], -shift[1]), slice(-shift[1], None)):
            for w in (slice(0, -window[2]), slice(-window[2], -shift[2]), slice(-shift[2], None)):
                img[d, h, w] = cnt
                cnt += 1
    wd, wh, ww = window
    img = img.reshape(D // wd, wd, H // wh, wh, W // ww, ww)
    img = img.transpose(0, 2, 4, 1, 3, 5).reshape(-1, wd * wh * ww)
    diff = img[:, None, :] - img[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@lru_cache(maxsize=None)
def relative_position_index(window: Tuple[int, int, int]) -> np.ndarray:
    """(N, N) index into the (2wd-1)(2wh-1)(2ww-1) bias table."""
    wd, wh, ww = window
    coords = np.stack(np.meshgrid(np.arange(wd), np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(3, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += wd - 1
    rel[:, :, 1] += wh - 1
    rel[:, :, 2] += ww - 1
    rel[:, :, 0] *= (2 * wh - 1) * (2 * ww - 1)
    rel[:, :, 1] *= 2 * ww - 1
    return rel.sum(-1)


# --- attention parameters and plain math -------------------------------------------
class WindowAttention3D(nn.Module):
    """Parameters of the window attention: relative position bias table for
    the constructor window, bias-free qkv and a biased output projection."""

    def __init__(self, dim: int, window_size: Tuple[int, int, int], heads: int = 8,
                 dim_head: int = 32):
        super().__init__()
        wd, wh, ww = window_size
        self.window_size = tuple(window_size)
        hidden = heads * dim_head
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * wd - 1) * (2 * wh - 1) * (2 * ww - 1), heads))
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.qkv = nn.Linear(dim, 3 * hidden, bias=False)
        self.proj = nn.Linear(hidden, dim)

    def bias_hnn(self, N: int) -> torch.Tensor:
        """(heads, N, N) bias for a (possibly clamped) window of N tokens."""
        table = self.relative_position_bias_table
        idx = torch.as_tensor(relative_position_index(self.window_size)[:N, :N],
                              device=table.device)
        return table[idx].permute(2, 0, 1)


def _split_heads(a: torch.Tensor, heads: int, dim_head: int) -> torch.Tensor:
    """(..., n, heads*dim_head) -> (..., heads, n, dim_head)."""
    return a.unflatten(-1, (heads, dim_head)).transpose(-3, -2)


def _merge_heads(a: torch.Tensor) -> torch.Tensor:
    return a.transpose(-3, -2).flatten(-2)


def _attend(q, k, v, bias, dim_head: int):
    """softmax(rope(q * dh^-0.5) rope(k)^T + bias) v, softmax in float32."""
    q = apply_rotary(q * dim_head ** -0.5, 32)
    k = apply_rotary(k, 32)
    s = q @ k.transpose(-1, -2) + bias.to(q.dtype)
    return torch.softmax(s.float(), dim=-1).to(q.dtype) @ v


def window_attention(windows: torch.Tensor, w_qkv: torch.Tensor, w_proj: torch.Tensor,
                     b_proj: torch.Tensor, bias_hnn: torch.Tensor, mask: Optional[torch.Tensor],
                     heads: int, dim_head: int) -> torch.Tensor:
    """Window attention over (B*nW, N, C) windows; mask (nW, N, N) or None.
    Weights in torch Linear layout (out, in)."""
    Bn = windows.shape[0]
    q, k, v = (_split_heads(a, heads, dim_head) for a in (windows @ w_qkv.t()).chunk(3, -1))
    bias = bias_hnn
    if mask is not None:  # windows are batch-major: view as (B, nW, ...) for the mask
        nW = mask.shape[0]
        q, k, v = (a.unflatten(0, (Bn // nW, nW)) for a in (q, k, v))
        bias = bias + mask[:, None].to(bias.dtype)
    o = _attend(q, k, v, bias, dim_head).reshape(Bn, heads, -1, dim_head)
    return _merge_heads(o) @ w_proj.t() + b_proj


class TemporalAttention(nn.Module):
    """Parameters of the attention over time: bias-free qkv and output."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        hidden = heads * dim_head
        self.to_qkv = nn.Linear(dim, 3 * hidden, bias=False)
        self.to_out = nn.Linear(hidden, dim, bias=False)


class TemporalAttentionLayer(nn.Module):
    """LayerNorm + TemporalAttention (reference AttentionLayer)."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.attn = TemporalAttention(dim, heads, dim_head)


def temporal_attention(seq: torch.Tensor, w_qkv: torch.Tensor, w_out: torch.Tensor,
                       bias_hnn: torch.Tensor, heads: int, dim_head: int) -> torch.Tensor:
    """Attention over the T axis of (B, M, T, C) sequences; bias (heads, T, T)."""
    q, k, v = (_split_heads(a, heads, dim_head) for a in (seq @ w_qkv.t()).chunk(3, -1))
    return _merge_heads(_attend(q, k, v, bias_hnn, dim_head)) @ w_out.t()
