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

On the H100 it is bound by bytes at these sizes (N <= 64, D <= 32): one
block per group of sequences and one head keeps the scores on chip. The
TPU kernel packs P sequences into one (P N, P N) product with a -inf
off-diagonal to fill the MXU and sends P = 1 to its reference; neither is
carried over.

Its gradient is autograd of ``window_attention_plain`` (the counterpart of
``pallas_attn._attention_reference``), as JAX's ``custom_vjp``: the
autograd Function keeps only its inputs and the backward recomputes the
attention. JAX has no backward kernel here, and the port adds none.

The wrapper runs the kernel for CUDA tensors and the plain version for CPU
tensors, and counts launches in ``fused_window_attention.launches``.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from extdm_tpu_torch import _build
from extdm_tpu_torch.nn.attention import shifted_window_mask

__all__ = ["fused_window_attention", "window_attention_plain", "dedupe_masks", "mask_tables",
           "MAX_N", "MAX_D"]

MAX_N, MAX_D = 64, 32  # the kernel's shared-memory tiles


def dedupe_masks(mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(nW, N, N) -> (unique (M, N, N), ids (nW,)): the Swin shift masks have
    a few distinct patterns whatever nW (``pallas_attn.dedupe_masks``)."""
    flat = mask.reshape(mask.shape[0], -1)
    uniq, ids = np.unique(flat, axis=0, return_inverse=True)
    return uniq.reshape(-1, mask.shape[1], mask.shape[2]), ids.reshape(-1).astype(np.int32)


@lru_cache(maxsize=None)
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
    if not q.is_cuda or any(t.device != q.device for t in (k, v, bias_hnn)):
        raise ValueError(f"fused_window_attention: kernel wrappers take CPU or CUDA tensors on "
                         f"one device, got {q.device}")
    if N > MAX_N or D > MAX_D:
        raise ValueError(f"fused_window_attention: the kernel takes N <= {MAX_N} and "
                         f"D <= {MAX_D}; got N={N}, D={D}")
    for name, t, shape in (("k", k, q.shape), ("v", v, q.shape), ("bias_hnn", bias_hnn, (H, N, N))):
        if tuple(t.shape) != tuple(shape) or (name != "bias_hnn" and t.dtype != q.dtype):
            raise ValueError(f"fused_window_attention: {name} is {t.dtype}{tuple(t.shape)}, "
                             f"q is {q.dtype}{tuple(q.shape)}")
    if mask is not None:
        masks, ids = mask
        if (masks.dtype != torch.float32 or ids.dtype != torch.int32 or masks.ndim != 3
                or tuple(masks.shape[1:]) != (N, N) or masks.device != q.device
                or ids.device != q.device or not (masks.is_contiguous() and ids.is_contiguous())):
            raise ValueError(f"fused_window_attention: mask tables {masks.dtype}"
                             f"{tuple(masks.shape)} / {ids.dtype} on {masks.device} for N = {N} "
                             f"on {q.device}")


def _forward(q, k, v, bias_hnn, mask):
    BW, H, N, D = q.shape
    masks, ids = (None, None) if mask is None else mask
    qc, kc, vc = (t.detach().contiguous() for t in (q, k, v))
    bias = bias_hnn.detach().float().contiguous()
    out = torch.empty_like(qc)
    G = MAX_N // (-(-N // 16) * 16)  # sequences per block: a 64-row tile of queries
    P = _build.ptr
    _build.launch("window_attn", "window_attention", _build.dtype_code(q.dtype), P(qc), P(kc),
                  P(vc), P(bias), P(masks), P(ids), P(out), BW, H, N, D,
                  0 if ids is None else ids.numel(), G, _build.stream(q))
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
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, bias_hnn, mask)
    _check(q, k, v, bias_hnn, mask)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, bias_hnn)):
        return _WindowAttention.apply(mask, q, k, v, bias_hnn)
    return _forward(q, k, v, bias_hnn, mask)


fused_window_attention.launches = 0
