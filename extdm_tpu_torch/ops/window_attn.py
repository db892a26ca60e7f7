"""Kernel 12 (``csrc/window_attn.cu``): small-sequence attention on
projected heads, the attention core of the unfused window and temporal
layers.

``fused_window_attention`` replaces ``extdm_tpu/ops/pallas_attn.py``
``fused_window_attention`` (``_attention_pallas`` -> ``_make_kernel``):
softmax(q k^T + bias + mask) v over (BW, H, N, D) sequences, q already
scaled and rotated, the (H, N, N) bias and, for shifted windows, the
shift masks as deduplicated tables (masks (M, N, N), ids (nW,)), sequence
i taking masks[ids[i % nW]] (``dedupe_masks``; ``mask_tables`` makes a
layer's tables once, by the volume, window and shift); the softmax in
float32, the output in q's dtype. The
layers of ``fused_stw.py`` that kernels 1 and 2 do not take
(``fused_stw.stw_route``) run their projections in torch around it.

On the H100 its time at these sizes (N <= 64, D <= 32, a few hundred
sequence-heads a launch) is latency: the launch, one round trip to memory
and the block's serial chain. The kernel reads q, k and v through their
strides (``window_attention_operands``: the head-split views of the layer's
qkv product pass uncopied), the bias through its strides in its own type
(float32 or bf16, no cast), and writes its output in (BW, N, H, D) order:
the wrapper returns the (BW, H, N, D) view of it, so the layer's head merge
is a view too. The TPU kernel packs P sequences into one (P N, P N) product
with a -inf off-diagonal to fill the MXU and sends P = 1 to its reference;
neither is carried over.

Its gradient is autograd of ``window_attention_plain`` (the counterpart of
``pallas_attn._attention_reference``), as JAX's ``custom_vjp``: the
autograd Function keeps only its inputs and the backward recomputes the
attention. JAX has no backward kernel here, and the port adds none.

The wrapper runs the kernel for CUDA tensors and the plain version for CPU
tensors, and counts launches in ``fused_window_attention.launches``.
"""
from __future__ import annotations

import ctypes
import struct
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from extdm_tpu_torch import _build
from extdm_tpu_torch.nn.attention import shifted_window_mask
from extdm_tpu_torch.utils.profiler import span

__all__ = ["fused_window_attention", "window_attention_plain", "window_attention_operands",
           "window_attention_output", "dedupe_masks", "mask_tables", "MAX_N", "MAX_D"]

MAX_N, MAX_D = 64, 32  # the kernel's shared-memory tiles


def dedupe_masks(mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(nW, N, N) -> (unique (M, N, N), ids (nW,)): the Swin shift masks have
    a few distinct patterns whatever nW (``pallas_attn.dedupe_masks``)."""
    flat = mask.reshape(mask.shape[0], -1)
    uniq, ids = np.unique(flat, axis=0, return_inverse=True)
    return uniq.reshape(-1, mask.shape[1], mask.shape[2]), ids.reshape(-1).astype(np.int32)


@lru_cache(maxsize=None)
@span("table_upload")
def mask_tables(Tp: int, Hp: int, Wp: int, window: Tuple[int, int, int],
                shift: Tuple[int, int, int], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The deduplicated shift masks of a padded (Tp, Hp, Wp) volume
    (``shifted_window_mask``) on `device`: (masks (M, N, N) float32, ids
    (nW,) int32). A pure function of its arguments, made once."""
    uniq, ids = dedupe_masks(shifted_window_mask(Tp, Hp, Wp, window, shift))
    return torch.as_tensor(uniq, device=device), torch.as_tensor(ids, device=device)


def window_attention_plain(q, k, v, bias_hnn, mask=None):
    """The semantics of ``pallas_attn._attention_reference``: scores, bias,
    mask, softmax and the product with v in float32, the output in q's
    dtype. q, k, v (BW, H, N, D); bias_hnn (H, N, N); mask None or the
    deduplicated (masks (M, N, N), ids (nW,)) of ``dedupe_masks`` /
    ``mask_tables`` as tensors, sequence i taking masks[ids[i % nW]]."""
    attn = q.float() @ k.float().transpose(-1, -2) + bias_hnn.float()
    if mask is not None:
        masks, ids = mask
        seq = ids.long()[torch.arange(q.shape[0], device=q.device) % ids.numel()]
        attn = attn + masks.float()[seq][:, None]
    return (torch.softmax(attn, dim=-1) @ v.float()).to(q.dtype)


def _check(q, k, v, bias_hnn, mask):
    BW, H, N, D = q.shape
    dev = q.get_device()  # -1 off the card
    if dev < 0 or k.get_device() != dev or v.get_device() != dev or bias_hnn.get_device() != dev:
        raise ValueError(f"fused_window_attention: kernel wrappers take CPU or CUDA tensors on "
                         f"one device, got {q.device}")
    if N > MAX_N or D > MAX_D:
        raise ValueError(f"fused_window_attention: the kernel takes N <= {MAX_N} and "
                         f"D <= {MAX_D}; got N={N}, D={D}")
    if (k.shape != q.shape or v.shape != q.shape or k.dtype != q.dtype or v.dtype != q.dtype
            or bias_hnn.shape != (H, N, N)):
        raise ValueError(f"fused_window_attention: k {k.dtype}{tuple(k.shape)}, v "
                         f"{v.dtype}{tuple(v.shape)}, bias {tuple(bias_hnn.shape)} for q "
                         f"{q.dtype}{tuple(q.shape)}")
    if mask is not None:
        masks, ids = mask
        if (masks.dtype != torch.float32 or ids.dtype != torch.int32 or masks.ndim != 3
                or masks.shape[1:] != (N, N) or masks.get_device() != dev
                or ids.get_device() != dev or not (masks.is_contiguous() and ids.is_contiguous())):
            raise ValueError(f"fused_window_attention: mask tables {masks.dtype}"
                             f"{tuple(masks.shape)} / {ids.dtype} on {masks.device} for N = {N} "
                             f"on {q.device}")


def window_attention_operands(q, k, v):
    """q, k and v as kernel 12 reads them, each as (tensor, data_ptr,
    strides), and whether it may copy their rows 16 bytes at a time. Each
    (BW, H, N, D) operand passes as it is when its last dim has unit stride
    (the head-split views of a qkv product do), else as a contiguous copy.
    The 16-byte copies (bf16) need every row to start on a 16-byte boundary:
    16-byte aligned data, strides and D multiples of 8 elements; other
    operands are read element by element."""
    ops, vec = [], q.dtype == torch.bfloat16 and q.shape[-1] % 8 == 0
    for t in (q, k, v):
        st = t.stride()
        if st[3] != 1:
            t = t.contiguous()
            st = t.stride()
        ptr = t.data_ptr()
        vec = vec and ptr % 16 == 0 and st[0] % 8 == 0 and st[1] % 8 == 0 and st[2] % 8 == 0
        ops.append((t, ptr, st))
    return ops, vec


def window_attention_output(q):
    """Kernel 12's output for q (BW, H, N, D): a (BW, N, H, D) buffer, as the
    kernel writes it, seen as (BW, H, N, D). Merging its heads
    (``nn.attention._merge_heads``) is then a view, not a copy."""
    BW, H, N, D = q.shape
    return q.new_empty_strided((BW, H, N, D), (N * H * D, D, H * D, 1))


# The kernel's operands, packed as int64 for one ctypes argument (see the C
# entry point's Param order); the C side reads them before it launches, so
# one buffer serves every call of the host thread that drives the card.
_PARAMS = struct.Struct("27q")
_PARAMS_BUF = ctypes.create_string_buffer(_PARAMS.size)
_PARAMS_ADDR = ctypes.addressof(_PARAMS_BUF)


def _forward(q, k, v, bias_hnn, mask):
    BW, H, N, D = q.shape
    masks, ids = (None, None) if mask is None else mask
    ((_, qp, (qb, qh, qn, _)), (_, kp, (kb, kh, kn, _)),
     (_, vp, (vb, vh, vn, _))), vec = window_attention_operands(q, k, v)
    bias = bias_hnn if bias_hnn.dtype in (torch.float32, torch.bfloat16) else bias_hnn.float()
    out = window_attention_output(q)
    G = MAX_N // (-(-N // 16) * 16)  # sequences per block: a 64-row tile of queries
    bh, bi, bj = bias.stride()
    _PARAMS.pack_into(_PARAMS_BUF, 0, qp, kp, vp, bias.data_ptr(),
                      0 if masks is None else masks.data_ptr(),
                      0 if ids is None else ids.data_ptr(), out.data_ptr(), qb, qh, qn, kb, kh,
                      kn, vb, vh, vn, int(vec), int(bias.dtype == torch.bfloat16), bh, bi, bj, BW,
                      H, N, D, 0 if ids is None else ids.numel(), G)
    _build.launch("window_attn", "window_attention", _build.dtype_code(q.dtype), _PARAMS_ADDR,
                  _build.stream(q))
    fused_window_attention.launches += 1
    return out


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mask, q, k, v, bias_hnn):
        ctx.mask = mask
        ctx.save_for_backward(q, k, v, bias_hnn)
        return _forward(q, k, v, bias_hnn, mask)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias_hnn = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(t.requires_grad) for t in (q, k, v, bias_hnn)]
            out = window_attention_plain(*ins, ctx.mask)
            live = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad(out, live, g))
        return (None, *(next(grads) if t.requires_grad else None for t in ins))


def fused_window_attention(q, k, v, bias_hnn, mask=None):
    """Kernel 12; same arguments and result as ``window_attention_plain``."""
    if not q.is_cuda and q.device.type == "cpu":
        return window_attention_plain(q, k, v, bias_hnn, mask)
    _check(q, k, v, bias_hnn, mask)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad
                                    or bias_hnn.requires_grad):
        return _WindowAttention.apply(mask, q, k, v, bias_hnn)
    return _forward(q, k, v, bias_hnn, mask)


fused_window_attention.launches = 0
