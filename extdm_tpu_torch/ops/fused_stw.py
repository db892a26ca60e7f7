"""Kernels 1 and 2 of the sampling path: whole attention layers (``csrc/attention.cu``).

``fused_stw_layer`` replaces ``extdm_tpu/ops/pallas_stw.py``
``fused_stw_layer`` (``_fused_padded`` -> ``_make_kernel``): the whole
PreNormSTW layer ``x + proj(attn(rope(ChanLN(x) Wqkv)))`` over 3-D windows.
``fused_temporal_layer`` replaces ``pallas_stw.fused_temporal_layer``
(``_temporal_impl`` -> ``_make_temporal_kernel``): the whole
PreNormTemporalAttn layer ``x + a + attn(LN(a))`` with ``a = ChanLN(x)``,
attention over T.

On the H100 both are bound by operations (the q/k/v and output products),
not bytes. One thread block owns one window, or the T-frame sequences of
64 / T pixels: it reads its tokens once, keeps norms, q/k/v, scores and the
per-head outputs in shared memory and registers, and writes the layer
output once; in bf16 every product runs on the tensor cores. The TPU
kernel's workarounds (head-pair packing, the block-scalar softmax max with
its -80 clamp, its sequence-packing score layout) are not carried over:
each query row takes its own max. Pad and roll of the shifted
layers stay outside the kernel, as in the JAX package; pad tokens are not
masked as keys, which matches the JAX semantics (their k is LN(0) W = 0).

Each wrapper runs its kernel for CUDA tensors and its plain version
(``stw_layer_plain``, ``temporal_layer_plain``) for CPU tensors, and counts
launches in ``<wrapper>.launches``. Weights are in torch Linear layout
(out, in).
"""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from extdm_tpu_torch import _build
from extdm_tpu_torch.nn.attention import (
    rotary_tables,
    shifted_window_mask,
    temporal_attention,
    window_attention,
    window_partition,
    window_reverse,
)
from extdm_tpu_torch.nn.layers import chan_layer_norm

__all__ = ["fused_stw_layer", "stw_layer_plain", "fused_temporal_layer", "temporal_layer_plain"]


def _pads(T: int, H: int, W: int, window) -> Tuple[int, int, int]:
    wd, wh, ww = window
    return (wd - T % wd) % wd, (wh - H % wh) % wh, (ww - W % ww) % ww


# ------------------------------------------------------------------------ STW
def stw_layer_plain(x, gamma, w_qkv, w_proj, b_proj, bias_hnn, *, window, shift, heads,
                    dim_head, eps=1e-5):
    """x + window attention of ChanLN(x): the semantics of
    ``pallas_stw.stw_layer_reference``. x: (B, T, H, W, C); bias_hnn
    (heads, N, N) for the call window; matmuls in x.dtype, softmax in float32."""
    B, T, H, W, C = x.shape
    dtype = x.dtype
    h = chan_layer_norm(x, gamma, eps)
    pd, ph, pw = _pads(T, H, W, window)
    h = F.pad(h, (0, 0, 0, pw, 0, ph, 0, pd))
    shifted = any(s > 0 for s in shift)
    if shifted:
        h = torch.roll(h, shifts=(-shift[0], -shift[1], -shift[2]), dims=(1, 2, 3))
    _, Tp, Hp, Wp, _ = h.shape
    mask = None
    if shifted:
        mask = torch.as_tensor(shifted_window_mask(Tp, Hp, Wp, tuple(window), tuple(shift)),
                               device=x.device)
    o = window_attention(window_partition(h, window), w_qkv.to(dtype), w_proj.to(dtype),
                         b_proj.to(dtype), bias_hnn, mask, heads, dim_head)
    out = window_reverse(o, window, B, Tp, Hp, Wp)
    if shifted:
        out = torch.roll(out, shifts=tuple(shift), dims=(1, 2, 3))
    return (x.float() + out[:, :T, :H, :W].float()).to(dtype)


@lru_cache(maxsize=None)
def _mask_tables(Tp, Hp, Wp, window, shift, device):
    """Deduplicated shift masks (n_unique, N, N) and each window's row."""
    m = shifted_window_mask(Tp, Hp, Wp, window, shift)
    uniq, ids = np.unique(m.reshape(m.shape[0], -1), axis=0, return_inverse=True)
    return (torch.as_tensor(uniq.reshape(-1, m.shape[1], m.shape[2]), device=device),
            torch.as_tensor(ids.reshape(-1).astype(np.int32), device=device))


@lru_cache(maxsize=None)
def _rope_tables(n, rot, device):
    cos, sin = rotary_tables(n, rot)
    return torch.as_tensor(cos, device=device), torch.as_tensor(sin, device=device)


def _check_cuda(x, *others):
    if not x.is_cuda:
        raise ValueError(f"kernel wrappers take CPU or CUDA tensors, got {x.device}")
    for t in others:
        if t.device != x.device:
            raise ValueError(f"operand on {t.device}, activation on {x.device}")


def _check_operands(what, x, N, heads, dim_head, **operands):
    """Kernel limits and operand shapes: (name -> (tensor, expected shape))."""
    C = x.shape[-1]
    if N > 64 or dim_head > 32 or C > 256 or (x.dtype == torch.bfloat16 and C % 32):
        raise ValueError(f"{what}: the kernel takes N <= 64 tokens, dim_head <= 32 and "
                         f"C <= 256 (in bf16 a multiple of 32); got N={N}, "
                         f"dim_head={dim_head}, C={C}")
    for name, (t, shape) in operands.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, expected {shape}")


def _f32(t):
    return t.detach().float().contiguous()


def fused_stw_layer(x, gamma, w_qkv, w_proj, b_proj, bias_hnn, *, window, shift, heads,
                    dim_head, eps=1e-5):
    """Whole PreNormSTW layer; same arguments and result as ``stw_layer_plain``."""
    if x.device.type == "cpu":
        return stw_layer_plain(x, gamma, w_qkv, w_proj, b_proj, bias_hnn, window=window,
                               shift=shift, heads=heads, dim_head=dim_head, eps=eps)
    _check_cuda(x, gamma, w_qkv, w_proj, b_proj, bias_hnn)
    B, T, H, W, C = x.shape
    wd, wh, ww = window
    N = wd * wh * ww
    hid = heads * dim_head
    _check_operands("fused_stw_layer", x, N, heads, dim_head, gamma=(gamma, (C,)),
                    w_qkv=(w_qkv, (3 * hid, C)), w_proj=(w_proj, (C, hid)),
                    b_proj=(b_proj, (C,)), bias_hnn=(bias_hnn, (heads, N, N)))
    pd, ph, pw = _pads(T, H, W, window)
    xp = F.pad(x, (0, 0, 0, pw, 0, ph, 0, pd))
    shifted = any(s > 0 for s in shift)
    if shifted:
        xp = torch.roll(xp, shifts=(-shift[0], -shift[1], -shift[2]), dims=(1, 2, 3))
    xp = xp.contiguous()
    _, Tp, Hp, Wp, _ = xp.shape
    masks = ids = None
    if shifted:
        masks, ids = _mask_tables(Tp, Hp, Wp, tuple(window), tuple(shift), x.device)
    rot = min(32, dim_head)
    cos, sin = _rope_tables(N, rot, x.device)
    out = torch.empty_like(xp)
    wq, wp = w_qkv.to(x.dtype).contiguous(), w_proj.to(x.dtype).contiguous()
    g, bp, bias = _f32(gamma), _f32(b_proj), _f32(bias_hnn)
    P = _build.ptr
    _build.launch("attention", "stw_layer", _build.dtype_code(x.dtype),
                  P(xp), P(out), P(g), P(wq), P(wp), P(bp), P(bias), P(masks), P(ids), P(cos),
                  P(sin), B, Tp, Hp, Wp, C, wd, wh, ww, heads, dim_head, rot, eps,
                  _build.stream(x))
    fused_stw_layer.launches += 1
    if shifted:
        out = torch.roll(out, shifts=tuple(shift), dims=(1, 2, 3))
    return out[:, :T, :H, :W]


fused_stw_layer.launches = 0


# ------------------------------------------------------------------- temporal
def temporal_layer_plain(x, gamma_cln, ln_scale, ln_bias, w_qkv, w_out, bias_hnn, *, heads,
                         dim_head, eps=1e-5):
    """x + undo_T(h + attn(LN(h))) with h = T(ChanLN(x)): the semantics of
    ``pallas_stw.temporal_layer_reference``. x: (B, T, H, W, C); bias (heads, T, T)."""
    B, T, H, W, C = x.shape
    dtype = x.dtype
    a = chan_layer_norm(x, gamma_cln, eps)
    h = a.permute(0, 2, 3, 1, 4).reshape(B, H * W, T, C)
    hn = F.layer_norm(h.float(), (C,), ln_scale.float(), ln_bias.float(), eps).to(dtype)
    o = temporal_attention(hn, w_qkv.to(dtype), w_out.to(dtype), bias_hnn, heads, dim_head)
    attn = (h.float() + o.float()).reshape(B, H, W, T, C).permute(0, 3, 1, 2, 4)
    return (x.float() + attn).to(dtype)


def fused_temporal_layer(x, gamma_cln, ln_scale, ln_bias, w_qkv, w_out, bias_hnn, *, heads,
                         dim_head, eps=1e-5):
    """Whole PreNormTemporalAttn layer; same arguments and result as
    ``temporal_layer_plain``."""
    if x.device.type == "cpu":
        return temporal_layer_plain(x, gamma_cln, ln_scale, ln_bias, w_qkv, w_out, bias_hnn,
                                    heads=heads, dim_head=dim_head, eps=eps)
    _check_cuda(x, gamma_cln, ln_scale, ln_bias, w_qkv, w_out, bias_hnn)
    B, T, H, W, C = x.shape
    hid = heads * dim_head
    _check_operands("fused_temporal_layer", x, T, heads, dim_head, gamma_cln=(gamma_cln, (C,)),
                    ln_scale=(ln_scale, (C,)), ln_bias=(ln_bias, (C,)),
                    w_qkv=(w_qkv, (3 * hid, C)), w_out=(w_out, (C, hid)),
                    bias_hnn=(bias_hnn, (heads, T, T)))
    x = x.contiguous()
    rot = min(32, dim_head)
    cos, sin = _rope_tables(T, rot, x.device)
    out = torch.empty_like(x)
    wq, wo = w_qkv.to(x.dtype).contiguous(), w_out.to(x.dtype).contiguous()
    g, s, b, bias = _f32(gamma_cln), _f32(ln_scale), _f32(ln_bias), _f32(bias_hnn)
    P = _build.ptr
    _build.launch("attention", "temporal_layer", _build.dtype_code(x.dtype),
                  P(x), P(out), P(g), P(s), P(b), P(wq), P(wo), P(bias), P(cos), P(sin), B, T,
                  H * W, C, heads, dim_head, rot, eps, _build.stream(x))
    fused_temporal_layer.launches += 1
    return out


fused_temporal_layer.launches = 0
