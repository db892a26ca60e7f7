"""Kernels 1, 2 and 9 (``csrc/attention.cu``) and the backward kernels 5 and
6 (``csrc/attention_bwd.cu``): whole attention layers.

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

``fused_stw_layer_wm`` replaces ``pallas_stw._fused_padded_wm``
(``_make_kernel_wm``): the same layer over pre-windowed (B, nW, N, C) tokens
(kernel 9). ``fused_stw_layer`` routes a layer through it when its
``window_major`` mode says so (``window_major_gate``, the gate of
``pallas_stw._window_major``: "0" never, "1" always, "auto" on unshifted
layers at a padded spatial size of 32 or more); the partition into windows
and its reverse are torch copies around the kernel, as in the JAX package.
Kernel 9 runs kernel 1's body on contiguous window rows, so it is bound by
operations as kernel 1 is. Under autograd the layer's backward is kernel 5
whatever the forward's layout, as JAX's ``custom_vjp``.

Each wrapper runs its kernel for CUDA tensors and its plain version
(``stw_layer_plain``, ``stw_layer_wm_plain``, ``temporal_layer_plain``) for
CPU tensors, and counts launches in ``<wrapper>.launches``. Weights are in
torch Linear layout (out, in).

Training: when an operand needs a gradient, the CUDA path runs as a
``torch.autograd.Function`` that saves the layer's inputs only (as the JAX
``custom_vjp`` does) and whose backward launches ``stw_layer_bwd`` (kernel 5,
replacing ``pallas_stw._stw_bwd_padded``) or ``temporal_layer_bwd`` (kernel
6, replacing ``pallas_stw._temporal_bwd_impl``), each counting its own
``.launches``. Their plain versions are ``stw_layer_plain_vjp`` and
``temporal_layer_plain_vjp``, the autograd of the plain forwards. Backward
functions take the cotangent first, then the forward's arguments, and
return one gradient per tensor argument, each in that argument's dtype.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from extdm_tpu_torch import _build
from extdm_tpu_torch.nn.attention import (
    apply_rotary,
    rotary_tables,
    shifted_window_mask,
    temporal_attention,
    window_attention,
    window_partition,
    window_reverse,
)
from extdm_tpu_torch.nn.layers import chan_layer_norm

__all__ = ["fused_stw_layer", "stw_layer_plain", "stw_layer_bwd", "stw_layer_plain_vjp",
           "WINDOW_MAJOR_MODES", "window_major_gate", "fused_stw_layer_wm", "stw_layer_wm_plain",
           "fused_temporal_layer", "temporal_layer_plain", "temporal_layer_bwd",
           "temporal_layer_plain_vjp"]


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


def _weights(x, *ws):
    """Weights in the activation dtype, as the kernels read them."""
    return [w.detach().to(x.dtype).contiguous() for w in ws]


def _needs_grad(*operands) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in operands)


def plain_vjp(fn, g, *operands, **kwargs):
    """Gradients of fn(*operands, **kwargs) with cotangent g, by autograd,
    one per operand (None where an operand is None)."""
    with torch.enable_grad():
        ins = [None if t is None else t.detach().requires_grad_(True) for t in operands]
        out = fn(*ins, **kwargs)
        live = [t for t in ins if t is not None]
        grads = iter(torch.autograd.grad(out, live, g, allow_unused=True))
    return tuple(None if t is None else next(grads) for t in ins)


@lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _splits(rows: int, m: int, k: int, device) -> int:
    """Splits over rows of a weight-gradient product, for ~4 blocks per SM."""
    tiles = -(-m // 64) * -(-k // 64)
    return max(1, min(-(-rows // 256), -(-4 * _sm_count(device) // tiles)))


def _pad_roll(x, window, shift):
    """Pad and roll x as the kernels take it, with the deduplicated shift
    masks and each window's id (None, None when unshifted)."""
    B, T, H, W, C = x.shape
    pd, ph, pw = _pads(T, H, W, window)
    xp = F.pad(x, (0, 0, 0, pw, 0, ph, 0, pd))
    shifted = any(s > 0 for s in shift)
    if shifted:
        xp = torch.roll(xp, shifts=(-shift[0], -shift[1], -shift[2]), dims=(1, 2, 3))
    xp = xp.contiguous()
    masks = ids = None
    if shifted:
        masks, ids = _mask_tables(*xp.shape[1:4], tuple(window), tuple(shift), x.device)
    return xp, masks, ids


def _stw_prepare(x, window, shift, heads, dim_head):
    """``_pad_roll`` and the rope tables."""
    xp, masks, ids = _pad_roll(x, window, shift)
    rot = min(32, dim_head)
    cos, sin = _rope_tables(window[0] * window[1] * window[2], rot, x.device)
    return xp, masks, ids, rot, cos, sin


def _stw_unroll(out, x_shape, shift):
    if any(s > 0 for s in shift):
        out = torch.roll(out, shifts=tuple(shift), dims=(1, 2, 3))
    _, T, H, W, _ = x_shape
    return out[:, :T, :H, :W]


def _stw_checked(what, x, gamma, w_qkv, w_proj, b_proj, bias_hnn, window, heads, dim_head):
    _check_cuda(x, gamma, w_qkv, w_proj, b_proj, bias_hnn)
    C = x.shape[-1]
    N = window[0] * window[1] * window[2]
    hid = heads * dim_head
    _check_operands(what, x, N, heads, dim_head, gamma=(gamma, (C,)),
                    w_qkv=(w_qkv, (3 * hid, C)), w_proj=(w_proj, (C, hid)),
                    b_proj=(b_proj, (C,)), bias_hnn=(bias_hnn, (heads, N, N)))


def _stw_forward(x, gamma, w_qkv, w_proj, b_proj, bias_hnn, *, window, shift, heads, dim_head,
                 eps, wm=False):
    if wm:
        return _stw_wm(x.detach(), gamma, w_qkv, w_proj, b_proj, bias_hnn, window=window,
                       shift=shift, heads=heads, dim_head=dim_head, eps=eps)
    _stw_checked("fused_stw_layer", x, gamma, w_qkv, w_proj, b_proj, bias_hnn, window, heads,
                 dim_head)
    C = x.shape[-1]
    xp, masks, ids, rot, cos, sin = _stw_prepare(x.detach(), window, shift, heads, dim_head)
    B, Tp, Hp, Wp, _ = xp.shape
    wd, wh, ww = window
    out = torch.empty_like(xp)
    wq, wp = _weights(x, w_qkv, w_proj)
    g, bp, bias = _f32(gamma), _f32(b_proj), _f32(bias_hnn)
    P = _build.ptr
    _build.launch("attention", "stw_layer", _build.dtype_code(x.dtype),
                  P(xp), P(out), P(g), P(wq), P(wp), P(bp), P(bias), P(masks), P(ids), P(cos),
                  P(sin), B, Tp, Hp, Wp, C, wd, wh, ww, heads, dim_head, rot, eps,
                  _build.stream(x))
    fused_stw_layer.launches += 1
    return _stw_unroll(out, x.shape, shift)


class _STWLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kw, wm, x, *params):
        ctx.kw = kw
        ctx.save_for_backward(x, *params)
        return _stw_forward(x, *params, wm=wm, **kw)

    @staticmethod
    def backward(ctx, g):
        return (None, None, *stw_layer_bwd(g, *ctx.saved_tensors, **ctx.kw))


def fused_stw_layer(x, gamma, w_qkv, w_proj, b_proj, bias_hnn, *, window, shift, heads,
                    dim_head, eps=1e-5, window_major="0"):
    """Whole PreNormSTW layer; same arguments and result as ``stw_layer_plain``.
    ``window_major`` ("0", "1" or "auto") picks the layout, see
    ``window_major_gate``."""
    kw = dict(window=tuple(window), shift=tuple(shift), heads=heads, dim_head=dim_head, eps=eps)
    operands = (x, gamma, w_qkv, w_proj, b_proj, bias_hnn)
    _, T, H, W, _ = x.shape
    _, ph, pw = _pads(T, H, W, window)
    wm = window_major_gate(window_major, any(s > 0 for s in shift), min(H + ph, W + pw))
    if x.device.type == "cpu":
        return _stw_wm(*operands, **kw) if wm else stw_layer_plain(*operands, **kw)
    if _needs_grad(*operands):
        return _STWLayer.apply(kw, wm, *operands)
    return _stw_forward(*operands, wm=wm, **kw)


fused_stw_layer.launches = 0


# ------------------------------------------------------------- STW, window-major
WINDOW_MAJOR_MODES = ("0", "1", "auto")


def window_major_gate(mode: str, shifted: bool, spatial: int) -> bool:
    """Whether a layer takes the window-major layout (kernel 9): the gate of
    ``pallas_stw._window_major`` as a plain function of the layout mode
    ("0": never, the default; "1": always; "auto": unshifted layers whose
    padded spatial size min(Hp, Wp) is 32 or more)."""
    if mode == "0":
        return False
    if mode == "1":
        return True
    if mode == "auto":
        return not shifted and spatial >= 32
    raise ValueError(f"window-major mode is one of {WINDOW_MAJOR_MODES}, got {mode!r}")


def _wm_partition(xp, window):
    """(B, Tp, Hp, Wp, C) -> (B, nW, N, C): tokens (t, h, w) within a window,
    windows in (t, h, w) order, as ``window_partition``."""
    B, Tp, Hp, Wp, C = xp.shape
    wd, wh, ww = window
    xw = xp.reshape(B, Tp // wd, wd, Hp // wh, wh, Wp // ww, ww, C)
    return xw.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(B, -1, wd * wh * ww, C)


def _wm_reverse(ow, window, padded_shape):
    """The inverse of ``_wm_partition``."""
    B, Tp, Hp, Wp, C = padded_shape
    wd, wh, ww = window
    o = ow.reshape(B, Tp // wd, Hp // wh, Wp // ww, wd, wh, ww, C)
    return o.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(B, Tp, Hp, Wp, C)


def _expand_masks(masks, mask_ids, n_tw, n_hw, n_ww, N):
    """(M, N, N) unique masks and each window's id -> (n_tw, n_hw, n_ww, N, N)."""
    return masks.float()[mask_ids.long()].reshape(n_tw, n_hw, n_ww, N, N)


def wm_operands(x, window, shift):
    """Kernel 9's token operands for a layer input x (B, T, H, W, C): x
    padded and rolled as for kernel 1, partitioned into windows (B, nW, N,
    C), the expanded shift masks (nW, N, N) or None, and the padded shape."""
    xp, masks, ids = _pad_roll(x, window, shift)
    masks_exp = None
    if masks is not None:
        _, Tp, Hp, Wp, _ = xp.shape
        N = window[0] * window[1] * window[2]
        masks_exp = _expand_masks(masks, ids, Tp // window[0], Hp // window[1],
                                  Wp // window[2], N).reshape(-1, N, N)
    return _wm_partition(xp, window), masks_exp, xp.shape


def _stw_wm(x, gamma, w_qkv, w_proj, b_proj, bias_hnn, *, window, shift, heads, dim_head, eps):
    """The layer through kernel 9 (``pallas_stw._layer_impl``'s window-major
    branch): pad, roll and partition into windows, run the windows, reverse
    the partition, roll back and crop."""
    xw, masks_exp, padded_shape = wm_operands(x, window, shift)
    ow = fused_stw_layer_wm(xw, gamma, w_qkv, w_proj, b_proj, bias_hnn, masks_exp, heads=heads,
                            dim_head=dim_head, eps=eps)
    return _stw_unroll(_wm_reverse(ow, window, padded_shape), x.shape, shift)


def stw_layer_wm_plain(xw, gamma, w_qkv, w_proj, b_proj, bias_hnn, masks_exp=None, *, heads,
                       dim_head, eps=1e-5):
    """xw + window attention of ChanLN(xw) over pre-windowed tokens, the
    semantics of ``pallas_stw._make_kernel_wm``. xw (B, nW, N, C); bias_hnn
    (heads, N, N); masks_exp (nW, N, N) or None; matmuls in xw.dtype,
    softmax in float32."""
    dtype = xw.dtype
    h = chan_layer_norm(xw, gamma, eps)
    q, k, v = (a.unflatten(-1, (heads, dim_head)).transpose(-3, -2)  # (B, nW, heads, N, dh)
               for a in (h @ w_qkv.to(dtype).t()).chunk(3, -1))
    q = apply_rotary(q * dim_head ** -0.5, 32)
    k = apply_rotary(k, 32)
    bias = bias_hnn if masks_exp is None else bias_hnn + masks_exp[:, None].to(bias_hnn.dtype)
    s = q @ k.transpose(-1, -2) + bias.to(dtype)
    o = torch.softmax(s.float(), dim=-1).to(dtype) @ v
    o = o.transpose(-3, -2).flatten(-2) @ w_proj.to(dtype).t() + b_proj.to(dtype)
    return (xw.float() + o.float()).to(dtype)


def fused_stw_layer_wm(xw, gamma, w_qkv, w_proj, b_proj, bias_hnn, masks_exp=None, *, heads,
                       dim_head, eps=1e-5):
    """Kernel 9: the PreNormSTW layer over pre-windowed tokens; same
    arguments and result as ``stw_layer_wm_plain``."""
    if xw.device.type == "cpu":
        return stw_layer_wm_plain(xw, gamma, w_qkv, w_proj, b_proj, bias_hnn, masks_exp,
                                  heads=heads, dim_head=dim_head, eps=eps)
    operands = [gamma, w_qkv, w_proj, b_proj, bias_hnn]
    _check_cuda(xw, *operands, *([] if masks_exp is None else [masks_exp]))
    B, nW, N, C = xw.shape
    hid = heads * dim_head
    shapes = dict(gamma=(gamma, (C,)), w_qkv=(w_qkv, (3 * hid, C)), w_proj=(w_proj, (C, hid)),
                  b_proj=(b_proj, (C,)), bias_hnn=(bias_hnn, (heads, N, N)))
    if masks_exp is not None:
        shapes["masks_exp"] = (masks_exp, (nW, N, N))
    _check_operands("fused_stw_layer_wm", xw, N, heads, dim_head, **shapes)
    xw = xw.detach().contiguous()
    out = torch.empty_like(xw)
    rot = min(32, dim_head)
    cos, sin = _rope_tables(N, rot, xw.device)
    wq, wp = _weights(xw, w_qkv, w_proj)
    g, bp, bias = _f32(gamma), _f32(b_proj), _f32(bias_hnn)
    masks = None if masks_exp is None else _f32(masks_exp)
    P = _build.ptr
    _build.launch("attention", "stw_layer_wm", _build.dtype_code(xw.dtype),
                  P(xw), P(out), P(g), P(wq), P(wp), P(bp), P(bias), P(masks), P(cos), P(sin),
                  B, nW, N, C, heads, dim_head, rot, eps, _build.stream(xw))
    fused_stw_layer_wm.launches += 1
    return out


fused_stw_layer_wm.launches = 0


def stw_layer_bwd(g, x, gamma, w_qkv, w_proj, b_proj, bias_hnn, *, window, shift, heads,
                  dim_head, eps=1e-5):
    """Kernel 5: (dx, dgamma, dw_qkv, dw_proj, db_proj, dbias) of
    ``fused_stw_layer`` at its inputs for the cotangent g. Pads and rolls g
    like x (``pallas_stw._stw_bwd_impl``), rolls dx back and crops it."""
    if x.device.type == "cpu":
        return stw_layer_plain_vjp(g, x, gamma, w_qkv, w_proj, b_proj, bias_hnn, window=window,
                                   shift=shift, heads=heads, dim_head=dim_head, eps=eps)
    _stw_checked("stw_layer_bwd", x, gamma, w_qkv, w_proj, b_proj, bias_hnn, window, heads,
                 dim_head)
    _check_cuda(x, g)
    C, hid = x.shape[-1], heads * dim_head
    xp, masks, ids, rot, cos, sin = _stw_prepare(x.detach(), window, shift, heads, dim_head)
    gp = _stw_prepare(g.detach().to(x.dtype), window, shift, heads, dim_head)[0]
    B, Tp, Hp, Wp, _ = xp.shape
    wd, wh, ww = window
    N = wd * wh * ww
    tokens = xp.numel() // C
    units = B * (Tp // wd) * (Hp // wh) * (Wp // ww)
    nblk = max(1, min(units, 2 * _sm_count(x.device)))
    sq, sp = _splits(tokens, 3 * hid, C, x.device), _splits(tokens, C, hid, x.device)
    f32 = dict(dtype=torch.float32, device=x.device)
    dxp, h_tok = torch.empty_like(xp), torch.empty_like(xp)
    dqkv, o_tok = torch.empty((tokens, 3 * hid), **f32), torch.empty((tokens, hid), **f32)
    vec_part = torch.empty((nblk, 2, C), **f32)
    bias_part = torch.empty((nblk, heads, N, N), **f32)
    w_part = torch.empty(max(sq * 3 * hid * C, sp * C * hid), **f32)
    vec, dbias = torch.empty(2 * C, **f32), torch.empty((heads, N, N), **f32)
    dwqkv, dwproj = torch.empty((3 * hid, C), **f32), torch.empty((C, hid), **f32)
    wq, wp = _weights(x, w_qkv, w_proj)
    gm, bias = _f32(gamma), _f32(bias_hnn)
    P = _build.ptr
    _build.launch("attention_bwd", "stw_layer_bwd", _build.dtype_code(x.dtype),
                  P(xp), P(gp), P(dxp), P(h_tok), P(wq), P(wp), P(gm), P(bias), P(masks), P(ids),
                  P(cos), P(sin), P(dqkv), P(o_tok), P(vec_part), P(bias_part), P(w_part),
                  P(vec), P(dbias), P(dwqkv), P(dwproj), B, Tp, Hp, Wp, C, wd, wh, ww,
                  heads, dim_head, rot, eps, nblk, sq, sp, _build.stream(x))
    stw_layer_bwd.launches += 1
    dx = _stw_unroll(dxp, x.shape, shift)
    return (dx, vec[:C].to(gamma.dtype), dwqkv.to(w_qkv.dtype), dwproj.to(w_proj.dtype),
            vec[C:].to(b_proj.dtype), dbias.to(bias_hnn.dtype))


stw_layer_bwd.launches = 0


def stw_layer_plain_vjp(g, x, gamma, w_qkv, w_proj, b_proj, bias_hnn, **kwargs):
    """The plain version of kernel 5: autograd of ``stw_layer_plain``."""
    return plain_vjp(stw_layer_plain, g, x, gamma, w_qkv, w_proj, b_proj, bias_hnn, **kwargs)


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


def _temporal_checked(what, x, gamma_cln, ln_scale, ln_bias, w_qkv, w_out, bias_hnn, heads,
                      dim_head):
    _check_cuda(x, gamma_cln, ln_scale, ln_bias, w_qkv, w_out, bias_hnn)
    B, T, H, W, C = x.shape
    hid = heads * dim_head
    _check_operands(what, x, T, heads, dim_head, gamma_cln=(gamma_cln, (C,)),
                    ln_scale=(ln_scale, (C,)), ln_bias=(ln_bias, (C,)),
                    w_qkv=(w_qkv, (3 * hid, C)), w_out=(w_out, (C, hid)),
                    bias_hnn=(bias_hnn, (heads, T, T)))


def _temporal_forward(x, gamma_cln, ln_scale, ln_bias, w_qkv, w_out, bias_hnn, *, heads,
                      dim_head, eps):
    _temporal_checked("fused_temporal_layer", x, gamma_cln, ln_scale, ln_bias, w_qkv, w_out,
                      bias_hnn, heads, dim_head)
    B, T, H, W, C = x.shape
    x = x.detach().contiguous()
    rot = min(32, dim_head)
    cos, sin = _rope_tables(T, rot, x.device)
    out = torch.empty_like(x)
    wq, wo = _weights(x, w_qkv, w_out)
    g, s, b, bias = _f32(gamma_cln), _f32(ln_scale), _f32(ln_bias), _f32(bias_hnn)
    P = _build.ptr
    _build.launch("attention", "temporal_layer", _build.dtype_code(x.dtype),
                  P(x), P(out), P(g), P(s), P(b), P(wq), P(wo), P(bias), P(cos), P(sin), B, T,
                  H * W, C, heads, dim_head, rot, eps, _build.stream(x))
    fused_temporal_layer.launches += 1
    return out


class _TemporalLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kw, x, *params):
        ctx.kw = kw
        ctx.save_for_backward(x, *params)
        return _temporal_forward(x, *params, **kw)

    @staticmethod
    def backward(ctx, g):
        return (None, *temporal_layer_bwd(g, *ctx.saved_tensors, **ctx.kw))


def fused_temporal_layer(x, gamma_cln, ln_scale, ln_bias, w_qkv, w_out, bias_hnn, *, heads,
                         dim_head, eps=1e-5):
    """Whole PreNormTemporalAttn layer; same arguments and result as
    ``temporal_layer_plain``."""
    kw = dict(heads=heads, dim_head=dim_head, eps=eps)
    operands = (x, gamma_cln, ln_scale, ln_bias, w_qkv, w_out, bias_hnn)
    if x.device.type == "cpu":
        return temporal_layer_plain(*operands, **kw)
    if _needs_grad(*operands):
        return _TemporalLayer.apply(kw, *operands)
    return _temporal_forward(*operands, **kw)


fused_temporal_layer.launches = 0


def temporal_layer_bwd(g, x, gamma_cln, ln_scale, ln_bias, w_qkv, w_out, bias_hnn, *, heads,
                       dim_head, eps=1e-5):
    """Kernel 6: (dx, dgamma_cln, dln_scale, dln_bias, dw_qkv, dw_out, dbias)
    of ``fused_temporal_layer`` at its inputs for the cotangent g."""
    if x.device.type == "cpu":
        return temporal_layer_plain_vjp(g, x, gamma_cln, ln_scale, ln_bias, w_qkv, w_out,
                                        bias_hnn, heads=heads, dim_head=dim_head, eps=eps)
    _temporal_checked("temporal_layer_bwd", x, gamma_cln, ln_scale, ln_bias, w_qkv, w_out,
                      bias_hnn, heads, dim_head)
    _check_cuda(x, g)
    B, T, H, W, C = x.shape
    hid = heads * dim_head
    x = x.detach().contiguous()
    gc = g.detach().to(x.dtype).contiguous()
    rot = min(32, dim_head)
    cos, sin = _rope_tables(T, rot, x.device)
    tokens = x.numel() // C
    G = 64 // T if T <= 64 else 1
    nblk = max(1, min(-(-(B * H * W) // G), 2 * _sm_count(x.device)))
    sq, sp = _splits(tokens, 3 * hid, C, x.device), _splits(tokens, C, hid, x.device)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx, h_tok = torch.empty_like(x), torch.empty_like(x)
    dqkv, o_tok = torch.empty((tokens, 3 * hid), **f32), torch.empty((tokens, hid), **f32)
    vec_part = torch.empty((nblk, 3, C), **f32)
    bias_part = torch.empty((nblk, heads, T, T), **f32)
    w_part = torch.empty(max(sq * 3 * hid * C, sp * C * hid), **f32)
    vec, dbias = torch.empty(3 * C, **f32), torch.empty((heads, T, T), **f32)
    dwqkv, dwout = torch.empty((3 * hid, C), **f32), torch.empty((C, hid), **f32)
    wq, wo = _weights(x, w_qkv, w_out)
    gm, s, b, bias = _f32(gamma_cln), _f32(ln_scale), _f32(ln_bias), _f32(bias_hnn)
    P = _build.ptr
    _build.launch("attention_bwd", "temporal_layer_bwd", _build.dtype_code(x.dtype),
                  P(x), P(gc), P(dx), P(h_tok), P(wq), P(wo), P(gm), P(s), P(b), P(bias), P(cos),
                  P(sin), P(dqkv), P(o_tok), P(vec_part), P(bias_part), P(w_part), P(vec),
                  P(dbias), P(dwqkv), P(dwout), B, T, H * W, C, heads, dim_head, rot, eps, nblk,
                  sq, sp, _build.stream(x))
    temporal_layer_bwd.launches += 1
    return (dx, vec[:C].to(gamma_cln.dtype), vec[C:2 * C].to(ln_scale.dtype),
            vec[2 * C:].to(ln_bias.dtype), dwqkv.to(w_qkv.dtype), dwout.to(w_out.dtype),
            dbias.to(bias_hnn.dtype))


temporal_layer_bwd.launches = 0


def temporal_layer_plain_vjp(g, x, gamma_cln, ln_scale, ln_bias, w_qkv, w_out, bias_hnn,
                             **kwargs):
    """The plain version of kernel 6: autograd of ``temporal_layer_plain``."""
    return plain_vjp(temporal_layer_plain, g, x, gamma_cln, ln_scale, ln_bias, w_qkv, w_out,
                     bias_hnn, **kwargs)
