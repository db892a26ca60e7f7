"""Kernels 1, 2 and 9 (``csrc/stw_layer.cu`` in bf16, ``csrc/attention.cu`` in
float32) and the backward kernels 5 and 6
(``csrc/stw_layer_bwd.cu`` in bf16, ``csrc/attention_bwd.cu`` in float32):
whole attention layers.

``fused_stw_layer`` replaces ``extdm_tpu/ops/pallas_stw.py``
``fused_stw_layer`` (``_fused_padded`` -> ``_make_kernel``): the whole
PreNormSTW layer ``x + proj(attn(rope(ChanLN(x) Wqkv)))`` over 3-D windows.
``fused_temporal_layer`` replaces ``pallas_stw.fused_temporal_layer``
(``_temporal_impl`` -> ``_make_temporal_kernel``): the whole
PreNormTemporalAttn layer ``x + a + attn(LN(a))`` with ``a = ChanLN(x)``,
attention over T.

On the H100 both are bound by operations (the q/k/v and output products),
not bytes. In attention.cu one thread block owns one window, or the
T-frame sequences of 64 / T pixels: it reads its tokens once, keeps norms,
q/k/v, scores and the
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
Kernel 9 is bound by operations as kernel 1 is; in bf16 it runs kernel 1's
body (``stw_layer_wm_wgmma``: a tile is one window's N contiguous rows, the
expanded masks one bias + mask table a window) at kernel 1's shapes. Under
autograd the layer's backward is kernel 5 whatever the forward's layout, as
JAX's ``custom_vjp``.

Kernels 1, 2, 5, 6 and 9 in float32 take N <= 64 tokens, dim_head <= 32
and C <= 256 channels (in bf16 a multiple of 32). Kernels 1,
5 and 9 in bf16 take C <= 512 (a multiple of 32) at dim_head 32 and 4 or 8
heads: kernel 1's body (``csrc/stw_layer.cu``: both products on wgmma, the
weights by TMA, the output tiled over channels; ``stw_plan`` gives its
shared-memory layout, weight ring and grid) and kernel 5's
(``csrc/stw_layer_bwd.cu``: the projections on wgmma, the attention's five
backward products on mma.sync, the weight gradients and dh on kernel 10's
engine; ``stw_bwd_plan``). Kernels 2 and 6 in bf16 run the same two bodies
templated on the layer kind (``temporal_layer_wgmma``,
``temporal_layer_bwd_wgmma``; ``temporal_plan``, ``temporal_bwd_plan``) at
T <= 32 frames, C <= 512 (a multiple of 32), dim_head 32 and 4 or 8 heads:
a tile holds two pixels' sequences read in place, and each entry first
writes the operands it reads (bf16 weights, the bias table with -inf past
T) from the parameters as the caller holds them (``temporal_operands_plain``
is their plain version). ``stw_route`` is the gate as a plain function of
shape, dtype and kind: a layer goes to its kernels (1 and 5, or 2 and 6)
where their bodies take it, with or without autograd. The layers it sends
"unfused" run ``stw_layer_unfused`` / ``temporal_layer_unfused``, JAX's
unfused modules (``PreNormSTW`` / ``PreNormTemporalAttn`` with the fused
layer off): the norms, pad and roll, partition, projections and rotary in
torch around kernel 12 (``ops/window_attn.py``), whose autograd keeps its
inputs only; the rest of the layer's autograd is torch's: in bf16 no preset
has such a layer.

Each wrapper runs its kernel for CUDA tensors and its plain version
(``stw_layer_plain``, ``stw_layer_wm_plain``, ``temporal_layer_plain``) for
CPU tensors, and counts launches in ``<wrapper>.launches``. Weights are in
torch Linear layout (out, in).

On an H shard (the spatial sampler, inference): ``spatial_stw_layer`` is
``pallas_stw._spatial_stw_layer`` (a cyclic halo in place of the global H
roll, the global shift masks by the ids of the shard's windows, a gather
where the windows cross the shards) and ``spatial_temporal_layer`` its
temporal counterpart (local). Kernels 1 and 9 mask a window by its id, not
by the shift, so ``fused_stw_layer(mask=(masks, ids))`` takes the tables a
shard needs whatever its local shift: an H-only shift runs locally
unshifted with the wrap masks of the global volume.

Training: when an operand needs a gradient, the CUDA path runs as a
``torch.autograd.Function`` that saves the layer's inputs only (as the JAX
``custom_vjp`` does) and whose backward launches ``stw_layer_bwd`` (kernel 5,
replacing ``pallas_stw._stw_bwd_padded``; in bf16 it reads x and g and
writes dx in place of the pad and roll, as kernel 1 does) or
``temporal_layer_bwd`` (kernel 6, replacing
``pallas_stw._temporal_bwd_impl``), each counting its own
``.launches``. Their plain versions are ``stw_layer_plain_vjp`` and
``temporal_layer_plain_vjp``, the autograd of the plain forwards. Backward
functions take the cotangent first, then the forward's arguments, and
return one gradient per tensor argument, each in that argument's dtype.
"""
from __future__ import annotations

import math
from functools import lru_cache, partial
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from extdm_tpu_torch import _build
from extdm_tpu_torch.nn.attention import (
    apply_rotary,
    rotary_on,
    rotary_tables,
    shifted_window_mask,
    temporal_attention,
    window_attention,
    window_partition,
    window_reverse,
)
from extdm_tpu_torch.nn.layers import chan_layer_norm
from extdm_tpu_torch.ops.conv_engine import wgrad_splits
from extdm_tpu_torch.ops.window_attn import fused_window_attention, mask_tables
from extdm_tpu_torch.utils.profiler import span

__all__ = ["stw_route", "stw_plan", "StwPlan", "stw_bwd_plan", "StwBwdPlan", "temporal_plan",
           "TemporalPlan", "temporal_bwd_plan", "temporal_operands", "temporal_operands_plain",
           "stw_layer_unfused",
           "temporal_layer_unfused", "fused_stw_layer", "stw_layer_plain", "stw_layer_bwd",
           "stw_layer_plain_vjp",
           "WINDOW_MAJOR_MODES", "window_major_gate", "fused_stw_layer_wm", "stw_layer_wm_plain",
           "fused_temporal_layer", "temporal_layer_plain", "temporal_layer_bwd",
           "temporal_layer_plain_vjp", "shard_mask_tables", "spatial_stw_layer",
           "spatial_temporal_layer"]


MAX_TOKENS, MAX_DIM_HEAD, MAX_CHANNELS = 64, 32, 256  # kernel 9; 1, 2, 5 and 6 in float32
MAX_WIDE_CHANNELS = 512  # kernels 1, 2, 5 and 6 in bf16 (csrc/stw_layer.cu, csrc/stw_layer_bwd.cu)
TEMPORAL_SLOTS = 32  # frames of a sequence in kernels 2 and 6's bf16 tiles (csrc/temporal.cuh SEQ)


def _narrow(C: int, N: int, dim_head: int, dtype) -> bool:
    """Whether kernels 2, 5, 6 and 9 (and kernel 1 in float32) take a layer."""
    fits = N <= MAX_TOKENS and dim_head <= MAX_DIM_HEAD and C <= MAX_CHANNELS
    return fits and (dtype != torch.bfloat16 or C % 32 == 0)


def _wide(C: int, N: int, heads: int, dim_head: int, dtype, temporal: bool = False) -> bool:
    """Whether the bf16 bodies (``csrc/stw_layer.cu``, ``csrc/stw_layer_bwd.cu``)
    take a layer: a window layer of N <= 64 tokens (kernels 1 and 5) or a
    temporal layer of N = T <= 32 frames (kernels 2 and 6)."""
    most = TEMPORAL_SLOTS if temporal else MAX_TOKENS
    return (dtype == torch.bfloat16 and N <= most and dim_head == 32 and heads in (4, 8)
            and C % 32 == 0 and C <= MAX_WIDE_CHANNELS)


def stw_route(C: int, N: int, dim_head: int, dtype, *, heads: int = 8,
              temporal: bool = False) -> str:
    """The route of an STW (N tokens a window) or temporal (N = T) layer of
    C channels, with or without autograd: "fused" where its kernels take it,
    else "unfused" (kernel 12 between torch projections). A window layer is
    kernel 1 forward and kernel 5 backward, a temporal layer kernels 2 and 6:
    in bf16 they take C <= 512 (dim_head 32, 4 or 8 heads; a temporal layer
    T <= 32), else the narrow limit (C <= 256)."""
    wide = _wide(C, N, heads, dim_head, dtype, temporal)
    return "fused" if _narrow(C, N, dim_head, dtype) or wide else "unfused"


STW_BOX = 64 * 128             # bytes of a 64 x 64 bf16 TMA box / swizzled tile
STW_QKV_STEP = 6 * STW_BOX     # a q/k/v step: two head pairs' q, k and v boxes
STW_SMEM_MAX = 232448          # shared memory of one block on the H100
STW_MAX_STAGES = 4


class StwPlan(NamedTuple):
    """How kernel 1's bf16 body runs a layer (``stw_plan``)."""
    cw: int            # output columns per warpgroup and round (64 or 128)
    rounds: int        # rounds of 2 cw output columns
    steps: int         # weight steps per window: q/k/v (head groups x 64-channel blocks), output
    resident: bool     # all weights stay in shared memory across a block's windows
    stages: int        # else: ring stages of STW_QKV_STEP bytes
    a_bufs: int        # x tiles: 2 prefetches the next window's rows
    smem: int          # dynamic shared memory of a block, bytes
    blocks: int        # persistent blocks at most (one per SM)


def _stw_smem(nkp: int, hk: int, a_bufs: int, wbytes: int, bars: int) -> int:
    """Bytes of csrc/stw_layer.cu's layout: x tiles, O, k, v^T, weights,
    mbarriers, row offsets, and 1024 for aligning the base."""
    return (a_bufs * nkp + hk + 4) * STW_BOX + wbytes + 8 * bars + 64 * 8 + 1024


@lru_cache(maxsize=256)
def stw_plan(C: int, N: int, heads: int, dim_head: int, sms: int) -> StwPlan:
    """The plan of kernel 1's bf16 body for a window layer of C channels, N
    tokens a window, `heads` x `dim_head` on a card of `sms` SMs: resident
    weights where they fit with everything else (C = 64: 128 KB), else a
    ring of the deepest stages that fits, two x tiles where they fit."""
    if not _wide(C, N, heads, dim_head, torch.bfloat16):
        raise ValueError(f"stw_plan: kernel 1's bf16 body takes N <= {MAX_TOKENS}, dim_head 32, "
                         f"4 or 8 heads and C <= {MAX_WIDE_CHANNELS} (a multiple of 32); got "
                         f"C={C}, N={N}, heads={heads}, dim_head={dim_head}")
    nkp, hk = -(-C // 64), heads * dim_head // 64
    cw = 64 if C <= 128 else 128
    rounds = -(-C // (2 * cw))
    qkv_steps = heads // 4 * nkp
    steps = qkv_steps + rounds * hk
    resident_bytes = qkv_steps * STW_QKV_STEP + rounds * hk * min(2 * cw // 64, nkp) * STW_BOX
    for a_bufs in (2, 1):
        smem = _stw_smem(nkp, hk, a_bufs, resident_bytes, 1)
        if smem <= STW_SMEM_MAX:
            return StwPlan(cw, rounds, steps, True, 0, a_bufs, smem, sms)
    for a_bufs in (2, 1):
        for stages in range(STW_MAX_STAGES, 1, -1):
            smem = _stw_smem(nkp, hk, a_bufs, stages * STW_QKV_STEP, stages)
            if smem <= STW_SMEM_MAX:
                return StwPlan(cw, rounds, steps, False, stages, a_bufs, smem, sms)
    raise ValueError(f"stw_plan: no layout of C={C} fits {STW_SMEM_MAX} bytes")


class TemporalPlan(NamedTuple):
    """How kernel 2's bf16 body (``csrc/stw_layer.cu`` ``temporal_layer_wgmma``)
    runs a layer (``temporal_plan``)."""
    cw: int            # output columns per warpgroup and round (64 or 128)
    rounds: int        # rounds of 2 cw output columns
    steps: int         # weight steps per tile: q/k/v (head groups x 64-channel blocks), output
    resident: bool     # all weights stay in shared memory across a block's tiles
    stages: int        # else: ring stages of STW_QKV_STEP bytes
    a_bufs: int        # x tiles: 2 prefetches the next tile's rows
    smem: int          # dynamic shared memory of a block, bytes
    blocks: int        # persistent blocks at most (one per SM)
    scratch: int       # bytes of the operands the entry writes (temporal_scratch_bytes)


@lru_cache(maxsize=256)
def temporal_plan(C: int, T: int, heads: int, dim_head: int, sms: int) -> TemporalPlan:
    """The plan of kernel 2's bf16 body for a temporal layer of C channels,
    T frames, `heads` x `dim_head` on a card of `sms` SMs: as ``stw_plan``
    (resident weights where they fit, else the deepest ring, two x tiles
    where they fit), the layout's bytes from the source's ``temporal_smem``
    query."""
    if not _wide(C, T, heads, dim_head, torch.bfloat16, temporal=True):
        raise ValueError(f"temporal_plan: kernel 2's bf16 body takes T <= {TEMPORAL_SLOTS}, "
                         f"dim_head 32, 4 or 8 heads and C <= {MAX_WIDE_CHANNELS} (a multiple of "
                         f"32); got C={C}, T={T}, heads={heads}, dim_head={dim_head}")
    nkp, hk = -(-C // 64), heads * dim_head // 64
    cw = 64 if C <= 128 else 128
    rounds = -(-C // (2 * cw))
    steps = heads // 4 * nkp + rounds * hk
    scratch = _build.query("stw_layer", "temporal_scratch_bytes", C, heads)
    layouts = [(True, 0, a) for a in (2, 1)] + [
        (False, s, a) for a in (2, 1) for s in range(STW_MAX_STAGES, 1, -1)]
    for resident, stages, a_bufs in layouts:
        smem = _build.query("stw_layer", "temporal_smem", C, heads, cw, int(resident), stages,
                            a_bufs)
        if smem <= STW_SMEM_MAX:
            return TemporalPlan(cw, rounds, steps, resident, stages, a_bufs, smem, sms, scratch)
    raise ValueError(f"temporal_plan: no layout of C={C} fits {STW_SMEM_MAX} bytes")


class StwBwdPlan(NamedTuple):
    """How kernel 5's bf16 body (``csrc/stw_layer_bwd.cu``) runs a layer
    (``stw_bwd_plan``)."""
    stages: int        # weight ring stages (each a head pair's q, k, v boxes)
    steps: int         # weight steps per window: dO's 64-channel blocks (per 128-column
                       #   half), then each head pair's
    smem: int          # dynamic shared memory of the window kernel's block, bytes
    blocks: int        # persistent window blocks at most (one per SM)
    ln_blocks: int     # blocks of the ChanLN backward (each one partial of dgamma, dbproj)


STW_BWD_MAX_STAGES = 4


@lru_cache(maxsize=256)
def stw_bwd_plan(C: int, N: int, heads: int, dim_head: int, sms: int) -> StwBwdPlan:
    """The plan of kernel 5's bf16 body for a window layer of C channels, N
    tokens a window, `heads` x `dim_head`, on a card of `sms` SMs: the
    deepest weight ring (at most STW_BWD_MAX_STAGES, at least two stages)
    whose layout fits one block's shared memory. The layout's bytes come
    from the source (its ``stw_bwd_smem`` query, the ``BwdPlan`` the
    kernel carves)."""
    if not _wide(C, N, heads, dim_head, torch.bfloat16):
        raise ValueError(f"stw_bwd_plan: kernel 5's bf16 body takes N <= {MAX_TOKENS}, dim_head "
                         f"32, 4 or 8 heads and C <= {MAX_WIDE_CHANNELS} (a multiple of 32); got "
                         f"C={C}, N={N}, heads={heads}, dim_head={dim_head}")
    return _bwd_ring("stw_bwd_plan", C, heads, dim_head, sms)


@lru_cache(maxsize=256)
def temporal_bwd_plan(C: int, T: int, heads: int, dim_head: int, sms: int) -> StwBwdPlan:
    """The plan of kernel 6's bf16 body (``csrc/stw_layer_bwd.cu``
    ``temporal_layer_bwd_wgmma``): kernel 5's, whose tile kernel it runs on
    two sequences of T <= 32 frames in place of a window."""
    if not _wide(C, T, heads, dim_head, torch.bfloat16, temporal=True):
        raise ValueError(f"temporal_bwd_plan: kernel 6's bf16 body takes T <= {TEMPORAL_SLOTS}, "
                         f"dim_head 32, 4 or 8 heads and C <= {MAX_WIDE_CHANNELS} (a multiple of "
                         f"32); got C={C}, T={T}, heads={heads}, dim_head={dim_head}")
    return _bwd_ring("temporal_bwd_plan", C, heads, dim_head, sms)


def _bwd_ring(what: str, C: int, heads: int, dim_head: int, sms: int) -> StwBwdPlan:
    """The deepest weight ring of kernels 5 and 6's tile kernel that fits."""
    steps = -(-C // 64) * (heads * dim_head // 128 + heads // 2)
    for stages in range(STW_BWD_MAX_STAGES, 1, -1):
        smem = _build.query("stw_layer_bwd", "stw_bwd_smem", C, heads, stages)
        if smem <= STW_SMEM_MAX:
            return StwBwdPlan(stages, steps, smem, sms, 2 * sms)
    raise ValueError(f"{what}: no layout of C={C} fits {STW_SMEM_MAX} bytes")


@lru_cache(maxsize=256)
def _temporal_bwd_scratch(tokens: int, C: int, heads: int, T: int, grid: int, ln_blocks: int,
                          splits_q: int, splits_p: int) -> int:
    return _build.query("stw_layer_bwd", "temporal_bwd_scratch_bytes", tokens, C, heads, T, grid,
                        ln_blocks, splits_q, splits_p)


def _pads(T: int, H: int, W: int, window) -> Tuple[int, int, int]:
    wd, wh, ww = window
    return (wd - T % wd) % wd, (wh - H % wh) % wh, (ww - W % ww) % ww


# ------------------------------------------------------------------------ STW
def stw_layer_plain(x, gamma, w_qkv, w_proj, b_proj, bias_hnn, *, window, shift, heads,
                    dim_head, eps=1e-5, attend=None, mask=None):
    """x + window attention of ChanLN(x): the semantics of
    ``pallas_stw.stw_layer_reference``. x: (B, T, H, W, C); bias_hnn
    (heads, N, N) for the call window; matmuls in x.dtype, softmax in float32.
    `attend`: the attention core of ``window_attention``, given the shift
    masks as ``window_attn.mask_tables``. `mask`: the (masks, ids) tables to
    apply in place of the shift's own, whatever the shift (an H shard's
    windows of a global volume, ``spatial_stw_layer``)."""
    B, T, H, W, C = x.shape
    dtype = x.dtype
    h = chan_layer_norm(x, gamma, eps)
    pd, ph, pw = _pads(T, H, W, window)
    h = F.pad(h, (0, 0, 0, pw, 0, ph, 0, pd))
    shifted = any(s > 0 for s in shift)
    if shifted:
        h = torch.roll(h, shifts=(-shift[0], -shift[1], -shift[2]), dims=(1, 2, 3))
    _, Tp, Hp, Wp, _ = h.shape
    if mask is not None and attend is None:
        mask = _expand_masks(*mask, Tp // window[0], Hp // window[1], Wp // window[2],
                             math.prod(window)).reshape(-1, *mask[0].shape[1:])
    elif shifted and attend is None:
        mask = shifted_window_mask(Tp, Hp, Wp, tuple(window), tuple(shift))
    elif shifted and mask is None:  # an attention core takes the deduplicated tables
        mask = mask_tables(Tp, Hp, Wp, tuple(window), tuple(shift), x.device)
    o = window_attention(window_partition(h, window), w_qkv.to(dtype), w_proj.to(dtype),
                         b_proj.to(dtype), bias_hnn, mask, heads, dim_head, attend)
    out = window_reverse(o, window, B, Tp, Hp, Wp)
    if shifted:
        out = torch.roll(out, shifts=tuple(shift), dims=(1, 2, 3))
    return (x.float() + out[:, :T, :H, :W].float()).to(dtype)


@lru_cache(maxsize=None)
@span("table_upload")
def _rope_pairs(n, rot, device):
    """The rope tables of kernel 1's bf16 body: (n, rot / 2, 4) float32, the
    cos and sin of dims 2 i and 2 i + 1 side by side."""
    cos, sin = rotary_tables(n, rot)
    pairs = np.stack([cos[:, 0::2], sin[:, 0::2], cos[:, 1::2], sin[:, 1::2]], axis=-1)
    return torch.as_tensor(np.ascontiguousarray(pairs), device=device)


def bias_mask_table(bias, masks=None):
    """Kernel 1's bf16 body reads bias and shift mask as one table: (M,
    heads, 64, 64) bf16 of bias + masks[m] (M = 1, the bias alone, when
    unshifted), -inf past N: padding keys and rows then need no test in the
    kernel. The reference adds the two and casts to the compute dtype before
    adding them to the scores, so the table holds the values it adds."""
    b = bias[None] if masks is None else bias[None] + masks[:, None]  # summed in float32
    N = b.shape[-1]
    if N < MAX_TOKENS:
        b = F.pad(b.float(), (0, MAX_TOKENS - N, 0, MAX_TOKENS - N), value=float("-inf"))
    return b.to(torch.bfloat16).contiguous()


def _check_cuda(x, *others):
    if not x.is_cuda:
        raise ValueError(f"kernel wrappers take CPU or CUDA tensors, got {x.device}")
    for t in others:
        if t.device != x.device:
            raise ValueError(f"operand on {t.device}, activation on {x.device}")


def _check_operands(what, x, N, heads, dim_head, wide=None, **operands):
    """Kernel limits and operand shapes: (name -> (tensor, expected shape)).
    `wide`: the layer kind ("window" or "temporal") whose bf16 body may take
    the layer (None: the narrow body only)."""
    C = x.shape[-1]
    fits_wide = wide is not None and _wide(C, N, heads, dim_head, x.dtype, wide == "temporal")
    if not (_narrow(C, N, dim_head, x.dtype) or fits_wide):
        raise ValueError(f"{what}: the kernel takes N <= {MAX_TOKENS} tokens, dim_head <= "
                         f"{MAX_DIM_HEAD} and C <= {MAX_CHANNELS} (in bf16 a multiple of 32; a "
                         f"bf16 layer at dim_head 32 and 4 or 8 heads C <= {MAX_WIDE_CHANNELS}, "
                         f"a temporal one at T <= {TEMPORAL_SLOTS}); got N={N}, "
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


def _pad_roll(x, window, shift, mask=None):
    """Pad and roll x as the kernels take it, with the deduplicated shift
    masks and each window's id (None, None when unshifted; `mask` where
    given)."""
    B, T, H, W, C = x.shape
    pd, ph, pw = _pads(T, H, W, window)
    xp = F.pad(x, (0, 0, 0, pw, 0, ph, 0, pd))
    shifted = any(s > 0 for s in shift)
    if shifted:
        xp = torch.roll(xp, shifts=(-shift[0], -shift[1], -shift[2]), dims=(1, 2, 3))
    xp = xp.contiguous()
    masks, ids = mask if mask is not None else (None, None)
    if shifted and mask is None:
        masks, ids = mask_tables(*xp.shape[1:4], tuple(window), tuple(shift), x.device)
    return xp, masks, ids


def _stw_prepare(x, window, shift, heads, dim_head, mask=None):
    """``_pad_roll`` and the rope tables."""
    xp, masks, ids = _pad_roll(x, window, shift, mask)
    rot = min(32, dim_head)
    cos, sin = rotary_on(window[0] * window[1] * window[2], rot, torch.float32, x.device)
    return xp, masks, ids, rot, cos, sin


def _stw_unroll(out, x_shape, shift):
    if any(s > 0 for s in shift):
        out = torch.roll(out, shifts=tuple(shift), dims=(1, 2, 3))
    _, T, H, W, _ = x_shape
    return out[:, :T, :H, :W]


def _stw_checked(what, x, gamma, w_qkv, w_proj, b_proj, bias_hnn, window, heads, dim_head,
                 wide=None):
    _check_cuda(x, gamma, w_qkv, w_proj, b_proj, bias_hnn)
    C = x.shape[-1]
    N = window[0] * window[1] * window[2]
    hid = heads * dim_head
    _check_operands(what, x, N, heads, dim_head, wide, gamma=(gamma, (C,)),
                    w_qkv=(w_qkv, (3 * hid, C)), w_proj=(w_proj, (C, hid)),
                    b_proj=(b_proj, (C,)), bias_hnn=(bias_hnn, (heads, N, N)))


def _stw_forward(x, gamma, w_qkv, w_proj, b_proj, bias_hnn, *, window, shift, heads, dim_head,
                 eps, wm=False, mask=None):
    if wm:
        return _stw_wm(x.detach(), gamma, w_qkv, w_proj, b_proj, bias_hnn, window=window,
                       shift=shift, heads=heads, dim_head=dim_head, eps=eps, mask=mask)
    _stw_checked("fused_stw_layer", x, gamma, w_qkv, w_proj, b_proj, bias_hnn, window, heads,
                 dim_head, wide="window")
    B, T, H, W, C = x.shape
    wd, wh, ww = window
    N = wd * wh * ww
    wq, wp = _weights(x, w_qkv, w_proj)
    g, bp = _f32(gamma), _f32(b_proj)
    P = _build.ptr
    if _wide(C, N, heads, dim_head, x.dtype):  # pad and roll read in place by the kernel
        x = x.detach().contiguous()
        pd, ph, pw = _pads(T, H, W, window)
        # the body masks a window by its id, whatever the shift
        masks, ids = mask if mask is not None else (None, None)
        if any(sh > 0 for sh in shift) and mask is None:
            masks, ids = mask_tables(T + pd, H + ph, W + pw, tuple(window), tuple(shift),
                                     x.device)
        plan = stw_plan(C, N, heads, dim_head, _sm_count(x.device))
        bm = bias_mask_table(bias_hnn.detach(), masks)
        rot = min(32, dim_head)
        out = torch.empty_like(x)
        _build.launch("stw_layer", "stw_layer_wgmma", P(x), P(out), P(g), P(wq), P(wp), P(bp),
                      P(bm), P(ids), P(_rope_pairs(N, rot, x.device)), B, T, H, W, C, wd, wh,
                      ww, shift[0], shift[1], shift[2], heads, rot, eps, plan.cw,
                      int(plan.resident), plan.stages, plan.a_bufs, plan.smem, plan.blocks,
                      _build.stream(x))
        fused_stw_layer.launches += 1
        return out
    xp, masks, ids, rot, cos, sin = _stw_prepare(x.detach(), window, shift, heads, dim_head,
                                                 mask)
    _, Tp, Hp, Wp, _ = xp.shape
    out = torch.empty_like(xp)
    bias = _f32(bias_hnn)
    _build.launch("attention", "stw_layer", _build.dtype_code(x.dtype),
                  P(xp), P(out), P(g), P(wq), P(wp), P(bp), P(bias), P(masks), P(ids),
                  P(cos), P(sin), B, Tp, Hp, Wp, C, wd, wh, ww, heads, dim_head, rot, eps,
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
                    dim_head, eps=1e-5, window_major="0", mask=None):
    """Whole PreNormSTW layer; same arguments and result as ``stw_layer_plain``.
    ``window_major`` ("0", "1" or "auto") picks the layout, see
    ``window_major_gate``; a layer with `mask` tables counts as shifted
    there. `mask` (inference only): the (masks, ids) tables to apply in
    place of the shift's own, as ``stw_layer_plain`` takes them."""
    kw = dict(window=tuple(window), shift=tuple(shift), heads=heads, dim_head=dim_head, eps=eps)
    operands = (x, gamma, w_qkv, w_proj, b_proj, bias_hnn)
    _, T, H, W, C = x.shape
    _, ph, pw = _pads(T, H, W, window)
    shifted = any(s > 0 for s in shift) or mask is not None
    wm = (window_major_gate(window_major, shifted, min(H + ph, W + pw))
          and _wm_takes(C, math.prod(window), heads, dim_head, x.dtype))
    if x.device.type == "cpu":
        if wm:
            return _stw_wm(*operands, mask=mask, **kw)
        return stw_layer_plain(*operands, mask=mask, **kw)
    if _needs_grad(*operands):
        if mask is not None:
            raise ValueError("fused_stw_layer: explicit mask tables are for inference; the "
                             "backward takes the shift's own")
        return _STWLayer.apply(kw, wm, *operands)
    return _stw_forward(*operands, wm=wm, mask=mask, **kw)


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


def _wm_takes(C: int, N: int, heads: int, dim_head: int, dtype) -> bool:
    """Whether kernel 9 takes a layer: in bf16 kernel 1's shapes (its body,
    C <= 512), else the narrow body's (C <= 256)."""
    return _wide(C, N, heads, dim_head, dtype) or C <= MAX_CHANNELS


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


def wm_operands(x, window, shift, mask=None):
    """Kernel 9's token operands for a layer input x (B, T, H, W, C): x
    padded and rolled as for kernel 1, partitioned into windows (B, nW, N,
    C), the expanded shift masks (nW, N, N) or None (`mask`'s tables where
    given), and the padded shape."""
    xp, masks, ids = _pad_roll(x, window, shift, mask)
    masks_exp = None
    if masks is not None:
        _, Tp, Hp, Wp, _ = xp.shape
        N = window[0] * window[1] * window[2]
        masks_exp = _expand_masks(masks, ids, Tp // window[0], Hp // window[1],
                                  Wp // window[2], N).reshape(-1, N, N)
    return _wm_partition(xp, window), masks_exp, xp.shape


def _stw_wm(x, gamma, w_qkv, w_proj, b_proj, bias_hnn, *, window, shift, heads, dim_head, eps,
            mask=None):
    """The layer through kernel 9 (``pallas_stw._layer_impl``'s window-major
    branch): pad, roll and partition into windows, run the windows, reverse
    the partition, roll back and crop."""
    xw, masks_exp, padded_shape = wm_operands(x, window, shift, mask)
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
    arguments and result as ``stw_layer_wm_plain``. In bf16 at kernel 1's
    shapes (C <= 512) it runs kernel 1's body (``csrc/stw_layer.cu``
    ``stw_layer_wm_wgmma``: a tile is one window's N contiguous rows, the
    expanded masks one bias + mask table a window); otherwise
    ``attention.cu``'s ``stw_layer_wm``."""
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
    _check_operands("fused_stw_layer_wm", xw, N, heads, dim_head, wide="window", **shapes)
    if _wide(C, N, heads, dim_head, xw.dtype):
        out = _stw_wm_wgmma(xw, gamma, w_qkv, w_proj, b_proj, bias_hnn, masks_exp, heads=heads,
                            dim_head=dim_head, eps=eps)
    else:
        out = _stw_wm_narrow(xw, gamma, w_qkv, w_proj, b_proj, bias_hnn, masks_exp, heads=heads,
                             dim_head=dim_head, eps=eps)
    fused_stw_layer_wm.launches += 1
    return out


@lru_cache(maxsize=None)
def _window_ids(nW: int, device) -> torch.Tensor:
    """Each window's own bias + mask table: 0 .. nW - 1 (int32)."""
    return torch.arange(nW, dtype=torch.int32, device=device)


def _stw_wm_wgmma(xw, gamma, w_qkv, w_proj, b_proj, bias_hnn, masks_exp, *, heads, dim_head,
                  eps):
    """Kernel 9 on kernel 1's bf16 body: xw read and the output written in
    place; bias and mask added before the cast, as the reference adds them."""
    B, nW, N, C = xw.shape
    xw = xw.detach().contiguous()
    wq, wp = _weights(xw, w_qkv, w_proj)
    g, bp = _f32(gamma), _f32(b_proj)
    masks = None if masks_exp is None else masks_exp.detach().float()
    bm = bias_mask_table(bias_hnn.detach(), masks)
    ids = None if masks_exp is None else _window_ids(nW, xw.device)
    plan = stw_plan(C, N, heads, dim_head, _sm_count(xw.device))
    rot = min(32, dim_head)
    out = torch.empty_like(xw)
    P = _build.ptr
    _build.launch("stw_layer", "stw_layer_wm_wgmma", P(xw), P(out), P(g), P(wq), P(wp), P(bp),
                  P(bm), P(ids), P(_rope_pairs(N, rot, xw.device)), B, nW, N, C, heads, rot, eps,
                  plan.cw, int(plan.resident), plan.stages, plan.a_bufs, plan.smem, plan.blocks,
                  _build.stream(xw))
    return out


def _stw_wm_narrow(xw, gamma, w_qkv, w_proj, b_proj, bias_hnn, masks_exp, *, heads, dim_head,
                   eps):
    """Kernel 9 on ``attention.cu``'s body (MODE 2): float32, the other head
    shapes, and the parent's body of the bf16 layers (C <= 256)."""
    B, nW, N, C = xw.shape
    xw = xw.detach().contiguous()
    out = torch.empty_like(xw)
    rot = min(32, dim_head)
    cos, sin = rotary_on(N, rot, torch.float32, xw.device)
    wq, wp = _weights(xw, w_qkv, w_proj)
    g, bp, bias = _f32(gamma), _f32(b_proj), _f32(bias_hnn)
    masks = None if masks_exp is None else _f32(masks_exp)
    P = _build.ptr
    _build.launch("attention", "stw_layer_wm", _build.dtype_code(xw.dtype),
                  P(xw), P(out), P(g), P(wq), P(wp), P(bp), P(bias), P(masks), P(cos), P(sin),
                  B, nW, N, C, heads, dim_head, rot, eps, _build.stream(xw))
    return out


fused_stw_layer_wm.launches = 0


def stw_layer_bwd(g, x, gamma, w_qkv, w_proj, b_proj, bias_hnn, *, window, shift, heads,
                  dim_head, eps=1e-5):
    """Kernel 5: (dx, dgamma, dw_qkv, dw_proj, db_proj, dbias) of
    ``fused_stw_layer`` at its inputs for the cotangent g. In bf16 at the
    shapes kernel 1's bf16 body takes (C <= 512), ``csrc/stw_layer_bwd.cu``
    reads x and g and writes dx in place of the pad and roll; otherwise
    (float32, the check path) ``attention_bwd.cu`` on padded, rolled copies
    (``pallas_stw._stw_bwd_impl``), dx rolled back and cropped."""
    if x.device.type == "cpu":
        return stw_layer_plain_vjp(g, x, gamma, w_qkv, w_proj, b_proj, bias_hnn, window=window,
                                   shift=shift, heads=heads, dim_head=dim_head, eps=eps)
    _stw_checked("stw_layer_bwd", x, gamma, w_qkv, w_proj, b_proj, bias_hnn, window, heads,
                 dim_head, wide="window")
    _check_cuda(x, g)
    N = window[0] * window[1] * window[2]
    if _wide(x.shape[-1], N, heads, dim_head, x.dtype):
        grads = _stw_bwd_wgmma(g, x, gamma, w_qkv, w_proj, bias_hnn, window=window, shift=shift,
                               heads=heads, dim_head=dim_head, eps=eps)
    else:
        grads = _stw_bwd_narrow(g, x, gamma, w_qkv, w_proj, bias_hnn, window=window,
                                shift=shift, heads=heads, dim_head=dim_head, eps=eps)
    stw_layer_bwd.launches += 1
    dx, dgamma, dwqkv, dwproj, dbproj, dbias = grads
    return (dx, dgamma.to(gamma.dtype), dwqkv.to(w_qkv.dtype), dwproj.to(w_proj.dtype),
            dbproj.to(b_proj.dtype), dbias.to(bias_hnn.dtype))


def _stw_bwd_wgmma(g, x, gamma, w_qkv, w_proj, bias_hnn, *, window, shift, heads, dim_head, eps):
    """Kernel 5's bf16 body (``csrc/stw_layer_bwd.cu``): the window kernel,
    dh = dqkv Wqkv, the ChanLN backward and the weight gradients."""
    B, T, H, W, C = x.shape
    wd, wh, ww = window
    N = wd * wh * ww
    hid = heads * dim_head
    dev = x.device
    sms = _sm_count(dev)
    plan = stw_bwd_plan(C, N, heads, dim_head, sms)
    x = x.detach().contiguous()
    gc = g.detach().to(x.dtype).contiguous()
    pd, ph, pw = _pads(T, H, W, window)
    masks = ids = None
    if any(s > 0 for s in shift):
        masks, ids = mask_tables(T + pd, H + ph, W + pw, tuple(window), tuple(shift), dev)
    bm = bias_mask_table(bias_hnn.detach(), masks)
    bmt = bm.transpose(-1, -2).contiguous()
    rot = min(32, dim_head)
    tokens = B * T * H * W
    nwin = B * -(-T // wd) * -(-H // wh) * -(-W // ww)
    grid = min(plan.blocks, nwin)
    wq, wp = _weights(x, w_qkv, w_proj)
    gm = _f32(gamma)
    bf = dict(dtype=torch.bfloat16, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    h_tok, o_tok = torch.empty((tokens, C), **bf), torch.empty((tokens, hid), **bf)
    dqkv, dh = torch.empty((tokens, 3 * hid), **bf), torch.empty((tokens, C), **f32)
    bias_part = torch.empty((grid, heads, N, N), **f32)
    vec_part = torch.empty((plan.ln_blocks, 2, C), **f32)
    # token splits of the weight gradients on the conv engine (its cost model)
    sq = wgrad_splits(tokens, -(-3 * hid // 128) * -(-C // 128), sms)[0]
    sp = wgrad_splits(tokens, -(-C // 128) * -(-hid // 128), sms)[0]
    part_q = torch.empty((sq, 3 * hid, C), **f32) if sq > 1 else None
    part_p = torch.empty((sp, C, hid), **f32) if sp > 1 else None
    dx = torch.empty_like(x)
    vec, dbias = torch.empty(2 * C, **f32), torch.empty((heads, N, N), **f32)
    dwqkv, dwproj = torch.empty((3 * hid, C), **f32), torch.empty((C, hid), **f32)
    P = _build.ptr
    _build.launch("stw_layer_bwd", "stw_layer_bwd_wgmma", P(x), P(gc), P(dx), P(wq), P(wp), P(gm),
                  P(bm), P(bmt), P(ids), P(h_tok), P(o_tok),
                  P(dqkv), P(dh), P(bias_part), P(vec_part), P(part_q), P(part_p), P(vec),
                  P(dbias), P(dwqkv), P(dwproj), B, T, H, W, C, wd, wh, ww, shift[0], shift[1],
                  shift[2], heads, rot, eps, plan.stages, plan.smem, grid, plan.ln_blocks, sq,
                  sp, _build.stream(x))
    return dx, vec[:C], dwqkv, dwproj, vec[C:], dbias


def _stw_bwd_narrow(g, x, gamma, w_qkv, w_proj, bias_hnn, *, window, shift, heads, dim_head,
                    eps):
    """attention_bwd.cu's body (the float32 check path): pads and rolls x and
    g (``pallas_stw._stw_bwd_impl``), rolls dx back and crops it."""
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
    return _stw_unroll(dxp, x.shape, shift), vec[:C], dwqkv, dwproj, vec[C:], dbias


stw_layer_bwd.launches = 0


def stw_layer_plain_vjp(g, x, gamma, w_qkv, w_proj, b_proj, bias_hnn, **kwargs):
    """The plain version of kernel 5: autograd of ``stw_layer_plain``."""
    return plain_vjp(stw_layer_plain, g, x, gamma, w_qkv, w_proj, b_proj, bias_hnn, **kwargs)


# ------------------------------------------------------------------- temporal
def temporal_layer_plain(x, gamma_cln, ln_scale, ln_bias, w_qkv, w_out, bias_hnn, *, heads,
                         dim_head, eps=1e-5, attend=None):
    """x + undo_T(h + attn(LN(h))) with h = T(ChanLN(x)): the semantics of
    ``pallas_stw.temporal_layer_reference``. x: (B, T, H, W, C); bias (heads,
    T, T). `attend`: the attention core of ``temporal_attention``."""
    B, T, H, W, C = x.shape
    dtype = x.dtype
    a = chan_layer_norm(x, gamma_cln, eps)
    h = a.permute(0, 2, 3, 1, 4).reshape(B, H * W, T, C)
    hn = F.layer_norm(h.float(), (C,), ln_scale.float(), ln_bias.float(), eps).to(dtype)
    o = temporal_attention(hn, w_qkv.to(dtype), w_out.to(dtype), bias_hnn, heads, dim_head,
                           attend)
    attn = (h.float() + o.float()).reshape(B, H, W, T, C).permute(0, 3, 1, 2, 4)
    return (x.float() + attn).to(dtype)


def _temporal_checked(what, x, gamma_cln, ln_scale, ln_bias, w_qkv, w_out, bias_hnn, heads,
                      dim_head):
    _check_cuda(x, gamma_cln, ln_scale, ln_bias, w_qkv, w_out, bias_hnn)
    B, T, H, W, C = x.shape
    hid = heads * dim_head
    _check_operands(what, x, T, heads, dim_head, "temporal", gamma_cln=(gamma_cln, (C,)),
                    ln_scale=(ln_scale, (C,)), ln_bias=(ln_bias, (C,)),
                    w_qkv=(w_qkv, (3 * hid, C)), w_out=(w_out, (C, hid)),
                    bias_hnn=(bias_hnn, (heads, T, T)))


def temporal_operands_plain(w_qkv, w_out, gamma_cln, ln_scale, ln_bias, bias_hnn):
    """The operands kernels 2 and 6's bf16 bodies read, as their entries write
    them from the caller's parameters (``csrc/temporal.cuh``
    ``temporal_operands_kernel``): Wqkv and Wout in bf16, gamma_cln |
    ln_scale | ln_bias (3 C) float32, and the bias table (heads, 32, 32) bf16,
    bf16(bias) in rows and columns < T and -inf past T, with its transpose in
    the last two dims."""
    heads, T, _ = bias_hnn.shape
    pad = TEMPORAL_SLOTS - T
    bm = F.pad(bias_hnn.detach().to(torch.bfloat16).float(), (0, pad, 0, pad),
               value=float("-inf")).to(torch.bfloat16)
    return dict(wq=w_qkv.detach().to(torch.bfloat16), wo=w_out.detach().to(torch.bfloat16),
                vec=torch.cat([t.detach().float() for t in (gamma_cln, ln_scale, ln_bias)]),
                bm=bm, bmt=bm.transpose(-1, -2).contiguous())


def _same_dtype(*ts):
    """The tensors contiguous in one dtype the kernels read (float32 or bf16:
    the one they share, else float32; as they are where they already are)
    and its code."""
    dtype = ts[0].dtype
    if dtype not in (torch.float32, torch.bfloat16) or any(t.dtype != dtype for t in ts):
        dtype = torch.float32
    return ([t if t.dtype == dtype and t.is_contiguous() else t.detach().to(dtype).contiguous()
             for t in ts], _build.dtype_code(dtype))


def temporal_operands(w_qkv, w_out, gamma_cln, ln_scale, ln_bias, bias_hnn):
    """``temporal_operands_plain`` on the card: the first launch of kernels 2
    and 6's bf16 entries alone (``temporal_operands_only``), for a check."""
    if w_qkv.device.type == "cpu":
        return temporal_operands_plain(w_qkv, w_out, gamma_cln, ln_scale, ln_bias, bias_hnn)
    _check_cuda(w_qkv, w_out, gamma_cln, ln_scale, ln_bias, bias_hnn)
    (wq, wo), wcode = _same_dtype(w_qkv, w_out)
    (gm, ls, lb), vcode = _same_dtype(gamma_cln, ln_scale, ln_bias)
    (bias,), bcode = _same_dtype(bias_hnn)
    heads, T, _ = bias.shape
    C = wq.shape[1]
    bf = dict(dtype=torch.bfloat16, device=wq.device)
    out = dict(wq=torch.empty_like(wq, **bf), wo=torch.empty_like(wo, **bf),
               vec=torch.empty(3 * C, dtype=torch.float32, device=wq.device),
               bm=torch.empty((heads, TEMPORAL_SLOTS, TEMPORAL_SLOTS), **bf),
               bmt=torch.empty((heads, TEMPORAL_SLOTS, TEMPORAL_SLOTS), **bf))
    P = _build.ptr
    _build.launch("stw_layer", "temporal_operands_only", P(wq), P(wo), wcode, P(gm), P(ls), P(lb),
                  vcode, P(bias), bcode, P(out["wq"]), P(out["wo"]), P(out["vec"]), P(out["bm"]),
                  P(out["bmt"]), C, heads, T, _build.stream(wq))
    return out


def _temporal_forward(x, gamma_cln, ln_scale, ln_bias, w_qkv, w_out, bias_hnn, *, heads,
                      dim_head, eps):
    _temporal_checked("fused_temporal_layer", x, gamma_cln, ln_scale, ln_bias, w_qkv, w_out,
                      bias_hnn, heads, dim_head)
    x = x.detach().contiguous()
    body = (_temporal_wgmma if _wide(x.shape[-1], x.shape[1], heads, dim_head, x.dtype,
                                     temporal=True) else _temporal_narrow)
    out = body(x, gamma_cln, ln_scale, ln_bias, w_qkv, w_out, bias_hnn, heads=heads,
               dim_head=dim_head, eps=eps)
    fused_temporal_layer.launches += 1
    return out


def _temporal_wgmma(x, gamma_cln, ln_scale, ln_bias, w_qkv, w_out, bias_hnn, *, heads, dim_head,
                    eps):
    """Kernel 2's bf16 body (``csrc/stw_layer.cu`` ``temporal_layer_wgmma``):
    the operands from the parameters as the caller holds them, then the
    layer; two allocations and one call from here."""
    B, T, H, W, C = x.shape
    plan = temporal_plan(C, T, heads, dim_head, _sm_count(x.device))
    (wq, wo), wcode = _same_dtype(w_qkv, w_out)
    (gm, ls, lb), vcode = _same_dtype(gamma_cln, ln_scale, ln_bias)
    (bias,), bcode = _same_dtype(bias_hnn)
    out = torch.empty_like(x)
    scratch = torch.empty(plan.scratch, dtype=torch.uint8, device=x.device)
    rot = min(32, dim_head)
    P = _build.ptr
    _build.launch("stw_layer", "temporal_layer_wgmma", P(x), P(out), P(gm), P(ls), P(lb), vcode,
                  P(wq), P(wo), wcode, P(bias), bcode, P(_rope_pairs(T, rot, x.device)),
                  P(scratch), B, T, H * W, C, heads, rot, eps, plan.cw, int(plan.resident),
                  plan.stages, plan.a_bufs, plan.smem, plan.blocks, _build.stream(x))
    return out


def _temporal_narrow(x, gamma_cln, ln_scale, ln_bias, w_qkv, w_out, bias_hnn, *, heads, dim_head,
                     eps):
    """attention.cu's body (float32, and the bf16 shapes kernel 2's bf16 body
    refuses)."""
    B, T, H, W, C = x.shape
    rot = min(32, dim_head)
    cos, sin = rotary_on(T, rot, torch.float32, x.device)
    out = torch.empty_like(x)
    wq, wo = _weights(x, w_qkv, w_out)
    g, s, b, bias = _f32(gamma_cln), _f32(ln_scale), _f32(ln_bias), _f32(bias_hnn)
    P = _build.ptr
    _build.launch("attention", "temporal_layer", _build.dtype_code(x.dtype),
                  P(x), P(out), P(g), P(s), P(b), P(wq), P(wo), P(bias), P(cos), P(sin), B, T,
                  H * W, C, heads, dim_head, rot, eps, _build.stream(x))
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
    of ``fused_temporal_layer`` at its inputs for the cotangent g. In bf16 at
    the shapes kernel 2's bf16 body takes, ``csrc/stw_layer_bwd.cu``
    (``temporal_layer_bwd_wgmma``); otherwise (float32, the check path)
    ``attention_bwd.cu``."""
    if x.device.type == "cpu":
        return temporal_layer_plain_vjp(g, x, gamma_cln, ln_scale, ln_bias, w_qkv, w_out,
                                        bias_hnn, heads=heads, dim_head=dim_head, eps=eps)
    _temporal_checked("temporal_layer_bwd", x, gamma_cln, ln_scale, ln_bias, w_qkv, w_out,
                      bias_hnn, heads, dim_head)
    _check_cuda(x, g)
    x = x.detach().contiguous()
    gc = g.detach().to(x.dtype).contiguous()
    if _wide(x.shape[-1], x.shape[1], heads, dim_head, x.dtype, temporal=True):
        grads = _temporal_bwd_wgmma(gc, x, gamma_cln, ln_scale, ln_bias, w_qkv, w_out, bias_hnn,
                                    heads=heads, dim_head=dim_head, eps=eps)
    else:
        grads = _temporal_bwd_narrow(gc, x, gamma_cln, ln_scale, ln_bias, w_qkv, w_out,
                                     bias_hnn, heads=heads, dim_head=dim_head, eps=eps)
    temporal_layer_bwd.launches += 1
    dx, dg, ds, db, dwqkv, dwout, dbias = grads
    return (dx, dg.to(gamma_cln.dtype), ds.to(ln_scale.dtype), db.to(ln_bias.dtype),
            dwqkv.to(w_qkv.dtype), dwout.to(w_out.dtype), dbias.to(bias_hnn.dtype))


def _temporal_bwd_wgmma(g, x, gamma_cln, ln_scale, ln_bias, w_qkv, w_out, bias_hnn, *, heads,
                        dim_head, eps):
    """Kernel 6's bf16 body (``csrc/stw_layer_bwd.cu``): the operands, the
    tiles of two sequences, dhn = dqkv Wqkv, the norms' backward and the
    weight gradients, from one scratch buffer; three allocations and one
    call from here."""
    B, T, H, W, C = x.shape
    hid = heads * dim_head
    dev = x.device
    sms = _sm_count(dev)
    plan = temporal_bwd_plan(C, T, heads, dim_head, sms)
    tokens = B * T * H * W
    grid = min(plan.blocks, -(-(B * H * W) // 2))
    # token splits of the weight gradients on the conv engine (its cost model)
    sq = wgrad_splits(tokens, -(-3 * hid // 128) * -(-C // 128), sms)[0]
    sp = wgrad_splits(tokens, -(-C // 128) * -(-hid // 128), sms)[0]
    nbytes = _temporal_bwd_scratch(tokens, C, heads, T, grid, plan.ln_blocks, sq, sp)
    (wq, wo), wcode = _same_dtype(w_qkv, w_out)
    (gm, ls, lb), vcode = _same_dtype(gamma_cln, ln_scale, ln_bias)
    (bias,), bcode = _same_dtype(bias_hnn)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    dx = torch.empty_like(x)
    out = torch.empty(3 * C + heads * T * T + 3 * hid * C + C * hid, dtype=torch.float32,
                      device=dev)
    vec, dbias, dwqkv, dwout = out.split([3 * C, heads * T * T, 3 * hid * C, C * hid])
    P = _build.ptr
    _build.launch("stw_layer_bwd", "temporal_layer_bwd_wgmma", P(x), P(g), P(dx), P(gm), P(ls),
                  P(lb), vcode, P(wq), P(wo), wcode, P(bias), bcode, P(scratch), nbytes, P(vec),
                  P(dbias), P(dwqkv), P(dwout), B, T, H * W, C, heads, min(32, dim_head), eps,
                  plan.stages, plan.smem, grid, plan.ln_blocks, sq, sp, _build.stream(x))
    return (dx, vec[:C], vec[C:2 * C], vec[2 * C:], dwqkv.view(3 * hid, C), dwout.view(C, hid),
            dbias.view(heads, T, T))


def _temporal_bwd_narrow(gc, x, gamma_cln, ln_scale, ln_bias, w_qkv, w_out, bias_hnn, *, heads,
                         dim_head, eps):
    """attention_bwd.cu's body (float32, and the bf16 shapes kernel 6's bf16
    body refuses)."""
    B, T, H, W, C = x.shape
    hid = heads * dim_head
    rot = min(32, dim_head)
    cos, sin = rotary_on(T, rot, torch.float32, x.device)
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
    return dx, vec[:C], vec[C:2 * C], vec[2 * C:], dwqkv, dwout, dbias


temporal_layer_bwd.launches = 0


def temporal_layer_plain_vjp(g, x, gamma_cln, ln_scale, ln_bias, w_qkv, w_out, bias_hnn,
                             **kwargs):
    """The plain version of kernel 6: autograd of ``temporal_layer_plain``."""
    return plain_vjp(temporal_layer_plain, g, x, gamma_cln, ln_scale, ln_bias, w_qkv, w_out,
                     bias_hnn, **kwargs)


# ------------------------------------------------------------------ unfused
def stw_layer_unfused(x, gamma, w_qkv, w_proj, b_proj, bias_hnn, *, window, shift, heads,
                      dim_head, eps=1e-5, mask=None):
    """The PreNormSTW layer for the layers ``stw_route`` sends "unfused"
    (JAX's ``PreNormSTW`` with the fused layer off, ``WindowAttention3D``):
    ChanLN, pad and roll, window partition, the projections and rotary in
    torch, kernel 12 for the attention, the output projection, reverse and
    residual. Same arguments and result as ``stw_layer_plain``."""
    return stw_layer_plain(x, gamma, w_qkv, w_proj, b_proj, bias_hnn, window=window, shift=shift,
                           heads=heads, dim_head=dim_head, eps=eps, attend=fused_window_attention,
                           mask=mask)


def temporal_layer_unfused(x, gamma_cln, ln_scale, ln_bias, w_qkv, w_out, bias_hnn, *, heads,
                           dim_head, eps=1e-5):
    """The PreNormTemporalAttn layer for the layers ``stw_route`` sends
    "unfused": ``temporal_layer_plain`` with kernel 12 for the attention over
    T. Same arguments and result as ``temporal_layer_plain``."""
    return temporal_layer_plain(x, gamma_cln, ln_scale, ln_bias, w_qkv, w_out, bias_hnn,
                                heads=heads, dim_head=dim_head, eps=eps,
                                attend=fused_window_attention)


# ------------------------------------------------------- H-sharded layers
@lru_cache(maxsize=None)
def shard_mask_tables(Tp: int, H: int, Wp: int, window: Tuple[int, int, int],
                      shift: Tuple[int, int, int], m: int, M: int, device):
    """The shift masks of the global padded (Tp, H, Wp) volume for H shard m
    of M: the deduplicated tables of the whole volume and the ids of the
    shard's windows, H windows [m n_hw / M, (m + 1) n_hw / M) of every
    (t, w) window row (the windows of ``window_partition`` over the shard's
    rows, in its order). Kernel 1 masks a window by its id, so a shard's
    kernel applies the global wrap masks whatever its local shift."""
    masks, ids = mask_tables(Tp, H, Wp, window, shift, device)
    n_hw = H // window[1]
    per = n_hw // M
    ids = ids.reshape(Tp // window[0], n_hw, Wp // window[2])[:, m * per:(m + 1) * per]
    return masks, ids.reshape(-1).contiguous()


def spatial_stw_layer(x, gamma, w_qkv, w_proj, b_proj, bias_hnn, *, window, shift, heads,
                      dim_head, shard, eps=1e-5, window_major="0", route="fused"):
    """The PreNormSTW layer on an H shard (``pallas_stw._spatial_stw_layer``):
    x (B, T, HL, W, C) is shard ``shard.m``'s rows of a global H = HL x
    ``shard.model``; `window` and `shift` are the layer's on the global
    shape. `route` is ``stw_route``'s: "fused" runs ``fused_stw_layer``
    (kernel 1, or kernel 9 where the window-major gate takes the local
    shape), "unfused" ``stw_layer_unfused`` (kernel 12). Three cases:

    - windows not within the shards (``shard.aligned``): gather the global
      H, run the whole layer, keep the shard's rows;
    - unshifted: the shard's windows are its own, the layer runs locally;
    - shifted: the global roll by -shift_h along H is the shard's rows
      after its first shift_h with the next shard's first shift_h below
      (a cyclic halo); the layer runs with shift (s_t, 0, s_w) and the
      global masks, the ids cut to the shard's windows
      (``shard_mask_tables``; an H-only shift keeps its wrap masks); a
      cyclic halo the other way rolls the output back."""
    layer = (stw_layer_unfused if route == "unfused"
             else partial(fused_stw_layer, window_major=window_major))
    params = (gamma, w_qkv, w_proj, b_proj, bias_hnn)
    kw = dict(window=tuple(window), heads=heads, dim_head=dim_head, eps=eps)
    B, T, HL, W, C = x.shape
    H = HL * shard.model
    if not shard.aligned(H, window[1]):
        return shard.slice_h(layer(shard.gather_h(x), *params, shift=tuple(shift), **kw))
    if not any(s > 0 for s in shift):
        return layer(x, *params, shift=tuple(shift), **kw)
    pd, _, pw = _pads(T, H, W, window)
    mask = shard_mask_tables(T + pd, H, W + pw, tuple(window), tuple(shift), shard.m,
                             shard.model, x.device)
    sh = shift[1]
    xr = shard.halo(x, 0, sh, "cyclic")[:, :, sh:] if sh else x
    out = layer(xr, *params, shift=(shift[0], 0, shift[2]), mask=mask, **kw)
    return shard.halo(out, sh, 0, "cyclic")[:, :, :HL] if sh else out


def spatial_temporal_layer(x, gamma_cln, ln_scale, ln_bias, w_qkv, w_out, bias_hnn, *, heads,
                           dim_head, eps=1e-5, route="fused"):
    """The PreNormTemporalAttn layer on an H shard
    (``pallas_stw._spatial_temporal_layer``): attention runs along T at
    each pixel, so a shard's rows need nothing of the others and kernel 2
    (or, on the "unfused" route, kernel 12) runs on them unchanged."""
    layer = temporal_layer_unfused if route == "unfused" else fused_temporal_layer
    return layer(x, gamma_cln, ln_scale, ln_bias, w_qkv, w_out, bias_hnn, heads=heads,
                 dim_head=dim_head, eps=eps)
