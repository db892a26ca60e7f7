"""Kernel 3, the whole ResnetBlock3d, and its backward, kernel 7 (``csrc/resnet.cu``).

Replaces ``extdm_tpu/ops/pallas_resnet.py`` ``fused_resnet_block``
(``_kernel_impl`` -> ``_make_kernel``): conv(1,3,3)+b -> GroupNorm -> FiLM
``h (scale + 1) + shift`` -> SiLU -> conv(1,3,3)+b -> GroupNorm -> SiLU ->
+ x, or + a 1x1 residual projection.

On the H100 the two 3x3 convs bound it by operations. The JAX kernel holds
a whole sample in VMEM so that GroupNorm's statistics need no reduction
across programs; an SM's shared memory holds a small fraction of a sample,
so the block runs as a short sequence of launches: each conv writes its
output and adds per-group sums into a float64 buffer, an elementwise pass
applies GroupNorm (+ FiLM + SiLU) for the next conv, and a last pass adds
the residual. In bf16 (``resnet_block_wgmma``) the convs run on kernel 10's
wgmma engine (``csrc/conv_ring.cuh``): 128-row tiles of pixels across
frames, weights tap-major by TMA (the bf16 copy of the weights, permuted
in the same launch; ``tap_major`` is its plain version), the residual
projection on the same tile with one tap; ``resnet_plan`` (a plain, tested
function) gives the grids, the channel padding and each conv's ring depth,
the source's ``resnet_scratch_bytes`` query the one scratch buffer the entry
carves. In float32 (the check path) the older FMA convs stage GroupNorm
into their input. The JAX VMEM gate (``pallas_resnet.supported``) has no
counterpart: every block of the path takes the kernels.

``fused_resnet_block`` runs the kernels for CUDA tensors and the plain
version (``resnet_block_plain``) for CPU tensors; ``fused_resnet_block.launches``
counts blocks run on the card. Weights are in torch Conv layout:
w1 (Cout, Cin, 1, 3, 3), w2 (Cout, Cout, 1, 3, 3), wres (Cout, Cin, 1, 1, 1).

Training: when an operand needs a gradient, the CUDA path runs as a
``torch.autograd.Function`` that saves the block's inputs only; its
backward launches ``resnet_block_bwd`` (kernel 7, replacing
``pallas_resnet._bwd_kernel_impl``), which recomputes the forward and takes
every gradient (dx, the conv weights per tap and their biases, both
GroupNorms' scale and bias, dFiLM (B, 2 Cout) and the residual projection's).
In bf16 (``resnet_block_bwd_wgmma``) it runs on the same engine: the
recompute on kernel 3's conv launches, each conv's input and weight
gradients on kernel 11's launch (``bwd_wgmma_kernel``; the residual
projection's 1 x 1 products on its one-tap variant), the GroupNorm, FiLM
and SiLU backward in bytes-bound passes whose per-channel sums are added in
a fixed order; one scratch buffer (``resnet_bwd_plan``, the source's
``resnet_bwd_scratch_bytes`` query) and one ctypes call a block, with JAX's
rounding points (y1, y2, dh1 and dx in float32 until dx's one rounding).
The plain backward is ``resnet_block_plain_vjp``. In float32 (the check
path) kernel 7 keeps its FMA body, whose per-channel sums in shared memory
take Cout <= 256.

``resnet_bwd_route`` (the gate of ``pallas_resnet._fused_bwd``) sends the
blocks kernel 7 does not take (float32 over 256 channels, more than 32
groups, groups that do not divide Cout) to ``resnet_block_bwd_decomposed``,
the counterpart of ``pallas_resnet._chunked_bwd``: it recomputes the two
convs with ``conv33_fwd`` (kernel 10, replacing
``pallas_resnet._conv33_fwd``) and takes each conv's gradients with
``conv33_bwd`` (kernel 11, replacing ``pallas_resnet._conv33_bwd``); the
GroupNorm, FiLM and SiLU chains and the per-channel sums around them stay
plain torch, as they stay XLA in JAX.
Kernels 10 and 11 (``csrc/conv33.cu``) are implicit GEMMs over the 9 taps,
bound by operations; in bf16 they run on ``wgmma`` fed by a ring of
shared-memory stages (cp.async for the tap-shifted pixel rows, TMA for the
weights). ``conv33_plan`` (a plain, tested function) gives their grids,
dW's pixel splits and the channel padding: counts that are not multiples of
8 are zero-padded by the wrapper (``conv33_fwd_operands`` /
``conv33_bwd_operands``), which passes operands that are already as the
kernels read them without a copy. Their plain versions are ``conv33_plain``
and ``conv33_bwd_plain``. On the CPU the decomposed backward runs the plain
convs.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from extdm_tpu_torch import _build
from extdm_tpu_torch.ops.conv_engine import (CONV_CHANNEL_ALIGN, CONV_SMEM, CONV_STAGES,
                                             CONV_STEP, CONV_TILE, ceil_div, ring_smem,
                                             wgrad_splits)
from extdm_tpu_torch.ops.fused_stw import _needs_grad, _sm_count, plain_vjp

__all__ = ["fused_resnet_block", "resnet_block_plain", "resnet_block_bwd",
           "resnet_block_plain_vjp", "resnet_bwd_route",
           "resnet_block_bwd_decomposed", "conv33_fwd", "conv33_plain", "conv33_bwd",
           "conv33_bwd_plain", "conv33_plan", "ConvPlan", "resnet_plan", "ResnetPlan",
           "resnet_bwd_plan", "ResnetBwdPlan", "tap_major"]

BWD_F32_MAX_COUT = 256  # kernel 7's float32 body keeps per-channel sums in shared memory
MAX_GROUPS = 32


def resnet_bwd_route(shape, cin: int, cout: int, groups: int, dtype) -> str:
    """The backward a block of input `shape` (B, T, H, W, cin) in `dtype`
    takes: "fused" (kernel 7) where kernel 7 takes the block, else
    "decomposed" (kernels 10 and 11 with the GroupNorm math in torch)."""
    return "fused" if _bwd_takes(cout, groups, dtype) else "decomposed"


def _bwd_takes(cout: int, groups: int, dtype) -> bool:
    """Kernel 7's limits: at most 32 groups dividing Cout; in float32 (its
    check path) Cout <= 256; in bf16 any width."""
    if groups > MAX_GROUPS or cout % groups:
        return False
    return dtype == torch.bfloat16 or cout <= BWD_F32_MAX_COUT


def _group_norm(y: torch.Tensor, scale, bias, groups: int, eps: float) -> torch.Tensor:
    """GroupNorm over (T, H, W, C/G) per sample, float32 statistics; returns float32."""
    B, T, H, W, C = y.shape
    g = y.float().reshape(B, T, H, W, groups, C // groups)
    mean = g.mean(dim=(1, 2, 3, 5), keepdim=True)
    var = ((g - mean) ** 2).mean(dim=(1, 2, 3, 5), keepdim=True)
    g = (g - mean) * torch.rsqrt(var + eps)
    return g.reshape(y.shape) * scale.float() + bias.float()


def _conv33(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(1,3,3) conv + bias on (B, T, H, W, C), frame by frame, in a.dtype."""
    B, T, H, W, C = a.shape
    y = F.conv2d(a.reshape(B * T, H, W, C).permute(0, 3, 1, 2), w.to(a.dtype).squeeze(2),
                 b.to(a.dtype), padding=1)
    return y.permute(0, 2, 3, 1).reshape(B, T, H, W, -1)


def resnet_block_plain(x, w1, b1, g1s, g1b, film: Optional[torch.Tensor], w2, b2, g2s, g2b,
                       wres=None, bres=None, *, groups=8, eps=1e-5):
    """The semantics of ``pallas_resnet.resnet_block_reference``: convs in
    x.dtype, GroupNorm statistics in float32. film: (B, 2*Cout) or None."""
    dtype = x.dtype
    h = _group_norm(_conv33(x, w1, b1), g1s, g1b, groups, eps)
    if film is not None:
        scale, shift = film.float().chunk(2, dim=-1)
        h = h * (scale[:, None, None, None] + 1.0) + shift[:, None, None, None]
    h = F.silu(h).to(dtype)
    h2 = F.silu(_group_norm(_conv33(h, w2, b2), g2s, g2b, groups, eps)).to(dtype)
    res = x
    if wres is not None:
        res = x @ wres.to(dtype).flatten(1).t() + bres.to(dtype)
    return (h2 + res).to(dtype)


def _check_block(what, x, w1, b1, g1s, g1b, film, w2, b2, g2s, g2b, wres, bres, groups):
    operands = [t for t in (w1, b1, g1s, g1b, film, w2, b2, g2s, g2b, wres, bres) if t is not None]
    if not x.is_cuda or any(t.device != x.device for t in operands):
        raise ValueError(f"{what}: activation on {x.device}, operands on "
                         f"{sorted({str(t.device) for t in operands})}")
    B, T, H, W, Cin = x.shape
    Cout = w1.shape[0]
    if groups > MAX_GROUPS or Cout % groups:
        raise ValueError(f"{what}: {Cout} channels in {groups} groups")
    if (wres is None) != (Cin == Cout):
        raise ValueError(f"{what}: a residual projection is needed iff Cin != Cout")
    shapes = {"w1": (w1, (Cout, Cin, 1, 3, 3)), "w2": (w2, (Cout, Cout, 1, 3, 3)),
              "film": (film, (B, 2 * Cout)), "wres": (wres, (Cout, Cin, 1, 1, 1))}
    shapes.update({n: (t, (Cout,)) for n, t in
                   (("b1", b1), ("g1s", g1s), ("g1b", g1b), ("b2", b2), ("g2s", g2s),
                    ("g2b", g2b), ("bres", bres))})
    for name, (t, shape) in shapes.items():
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, expected {shape}")


def _converted(x, w1, b1, g1s, g1b, film, w2, b2, g2s, g2b, wres, bres):
    """Weights in x.dtype and vectors in float32, as the kernels read them.
    The caller keeps them referenced until the launch has been queued."""
    weights = [None if t is None else t.detach().to(x.dtype).contiguous() for t in (w1, w2, wres)]
    vectors = [None if t is None else t.detach().float().contiguous()
               for t in (b1, g1s, g1b, film, b2, g2s, g2b, bres)]
    return weights, vectors


def _resnet_forward(x, w1, b1, g1s, g1b, film, w2, b2, g2s, g2b, wres, bres, *, groups, eps):
    _check_block("fused_resnet_block", x, w1, b1, g1s, g1b, film, w2, b2, g2s, g2b, wres, bres,
                 groups)
    if x.dtype == torch.bfloat16:
        return _resnet_forward_wgmma(x, w1, b1, g1s, g1b, film, w2, b2, g2s, g2b, wres, bres,
                                     groups=groups, eps=eps)
    B, T, H, W, Cin = x.shape
    Cout = w1.shape[0]
    dt = x.dtype
    x = x.detach().contiguous()
    (w1c, w2c, wresc), (b1c, g1sc, g1bc, filmc, b2c, g2sc, g2bc, bresc) = _converted(
        x, w1, b1, g1s, g1b, film, w2, b2, g2s, g2b, wres, bres)
    shape = (B, T, H, W, Cout)
    y1 = torch.empty(shape, dtype=dt, device=x.device)
    y2 = torch.empty_like(y1)
    r = torch.empty_like(y1) if wres is not None else None
    out = torch.empty_like(y1)
    stats = torch.zeros((2, B, groups, 2), dtype=torch.float64, device=x.device)
    P = _build.ptr
    _build.launch("resnet", "resnet_block", _build.dtype_code(dt),
                  P(x), P(w1c), P(b1c), P(g1sc), P(g1bc), P(filmc), P(w2c), P(b2c), P(g2sc),
                  P(g2bc), P(wresc), P(bresc), P(y1), P(y2), P(r), P(stats), P(out), B, T, H, W,
                  Cin, Cout, groups, eps, _build.stream(x))
    fused_resnet_block.launches += 1
    return out


class ResnetPlan(NamedTuple):
    """How the bf16 kernel 3 runs a block on kernel 10's engine (``resnet_plan``)."""
    cin: int            # channel counts the convs see: zero-padded up to a
    cout: int           #   multiple of CONV_CHANNEL_ALIGN
    conv1_grid: tuple   # (pixel tiles, Cout tiles, doubled with a residual projection)
    conv2_grid: tuple   # (pixel tiles, Cout tiles)
    stages1: int        # ring stages of conv1 and conv2: CONV_STAGES, or
    stages2: int        #   FEW_STEP_STAGES (two blocks an SM) for few reduction steps
    bn: int             # columns of a tile: CONV_TILE, or NARROW_TILE (below)
    smem1: int          # dynamic shared memory of their blocks, bytes
    smem2: int


# A conv of at most FEW_STEPS reduction steps (9 taps x 64-channel blocks:
# Cin <= 128) runs a FEW_STEP_STAGES-deep ring, so that two blocks (three
# with narrow tiles) share an SM and one's filling and draining overlaps the
# other's products. Tiles are NARROW_TILE columns wide where Cout is no
# wider (half the products of a 128-wide tile) or where 128-wide tiles would
# leave half the SMs without a block (twice the blocks: measured ahead at
# KTH's 4 x 4 blocks, 30 and 60 wide tiles, behind at its 8 x 8, 120).
FEW_STEPS = 18
FEW_STEP_STAGES = 3
NARROW_TILE = 64


@functools.lru_cache(maxsize=512)
def resnet_plan(pixels: int, cin: int, cout: int, residual: bool, sms: int) -> ResnetPlan:
    """The grids and rings of the bf16 kernel 3 for a block over `pixels`
    pixels (the frames of every sample flattened into the rows of 128-row
    tiles), cin -> cout channels, with or without the 1x1 residual
    projection (its tiles ride conv1's launch); channels padded as
    ``conv33_plan`` pads them, on a card of `sms` SMs."""
    cin_p, cout_p = (ceil_div(c, CONV_CHANNEL_ALIGN) * CONV_CHANNEL_ALIGN for c in (cin, cout))
    rows = ceil_div(pixels, CONV_TILE)
    narrow = cout_p <= NARROW_TILE or 2 * rows * ceil_div(cout_p, CONV_TILE) < sms
    bn = NARROW_TILE if narrow else CONV_TILE
    cols = ceil_div(cout_p, bn)
    s1, s2 = (FEW_STEP_STAGES if 9 * ceil_div(k, CONV_STEP) <= FEW_STEPS else CONV_STAGES
              for k in (cin_p, cout_p))
    return ResnetPlan(cin_p, cout_p, (rows, cols * (2 if residual else 1)), (rows, cols), s1, s2,
                      bn, ring_smem(s1, bn), ring_smem(s2, bn))


def tap_major(w: torch.Tensor, cin: int, cout: int) -> torch.Tensor:
    """torch Conv3d weights (Cout, Cin, 1, kh, kw) -> (kh kw, cin, cout)
    bf16, taps in (ky, kx) order, zero past the real channels: the layout
    kernel 3's TMA reads. The plain version of the conversion the kernel's
    entry makes on the card (``tap_major_kernel``: cast, permute and pad in
    one coalesced copy, into its scratch)."""
    Cout, Cin = w.shape[:2]
    taps = w.shape[-2] * w.shape[-1]
    out = torch.zeros((taps, cin, cout), dtype=torch.bfloat16, device=w.device)
    out[:, :Cin, :Cout] = w.detach()[:, :, 0].permute(2, 3, 1, 0).reshape(taps, Cin, Cout)
    return out


def _code(*ts) -> int:
    """The kernels' dtype code shared by tensors (``_build.dtype_code``)."""
    codes = {_build.dtype_code(t.dtype) for t in ts if t is not None}
    if len(codes) != 1:
        raise TypeError(f"kernel 3's parameters in one dtype, got {sorted(codes)}")
    return codes.pop()


def _resnet_forward_wgmma(x, w1, b1, g1s, g1b, film, w2, b2, g2s, g2b, wres, bres, *, groups,
                          eps):
    """Kernel 3 in bf16: the convs on kernel 10's wgmma tile (resnet.cu
    resnet_block_wgmma), which casts the parameters as it needs them into
    one scratch buffer: two allocations and one launch call from here."""
    B, T, H, W, Cin = x.shape
    Cout = w1.shape[0]
    pixels = B * T * H * W
    plan = resnet_plan(pixels, Cin, Cout, wres is not None, _sm_count(x.device))
    xp = _padded(x.detach().reshape(pixels, Cin), plan.cin)
    w1c, w2c, wrc, b1c, g1sc, g1bc, b2c, g2sc, g2bc, brc, filmc = (
        None if t is None else t.detach().contiguous()
        for t in (w1, w2, wres, b1, g1s, g1b, b2, g2s, g2b, bres, film))
    nbytes = _build.query("resnet", "resnet_scratch_bytes", B, pixels, plan.cin, plan.cout, Cout,
                          groups, int(wres is not None), int(film is not None))
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    out = torch.empty((B, T, H, W, Cout), dtype=torch.bfloat16, device=x.device)
    P = _build.ptr
    _build.launch("resnet", "resnet_block_wgmma", P(xp), P(w1c), P(w2c), P(wrc),
                  _code(w1c, w2c, wrc), P(b1c), P(g1sc), P(g1bc), P(b2c), P(g2sc), P(g2bc),
                  P(brc), _code(b1c, g1sc, g1bc, b2c, g2sc, g2bc, brc), P(filmc),
                  0 if film is None else _code(filmc), P(scratch), nbytes, P(out), B, T, H, W,
                  Cin, Cout, plan.cin, plan.cout, groups, eps, plan.stages1, plan.stages2,
                  plan.bn, _build.stream(x))
    fused_resnet_block.launches += 1
    return out


class _ResnetBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kw, x, *params):
        ctx.kw = kw
        ctx.save_for_backward(x, *params)
        return _resnet_forward(x, *params, **kw)

    @staticmethod
    def backward(ctx, g):
        x, w1 = ctx.saved_tensors[:2]
        route = resnet_bwd_route(x.shape, x.shape[-1], w1.shape[0], ctx.kw["groups"], x.dtype)
        bwd = resnet_block_bwd_decomposed if route == "decomposed" else resnet_block_bwd
        return (None, *bwd(g, *ctx.saved_tensors, **ctx.kw))


def fused_resnet_block(x, w1, b1, g1s, g1b, film: Optional[torch.Tensor], w2, b2, g2s, g2b,
                       wres=None, bres=None, *, groups=8, eps=1e-5):
    """Whole ResnetBlock3d; same arguments and result as ``resnet_block_plain``."""
    operands = (x, w1, b1, g1s, g1b, film, w2, b2, g2s, g2b, wres, bres)
    kw = dict(groups=groups, eps=eps)
    if x.device.type == "cpu":
        return resnet_block_plain(*operands, **kw)
    if _needs_grad(*[t for t in operands if t is not None]):
        return _ResnetBlock.apply(kw, *operands)
    return _resnet_forward(*operands, **kw)


fused_resnet_block.launches = 0


def _wgrad_splits(B, T, H, W, cin, cout, device) -> int:
    """Splits over pixel tiles of a conv weight gradient, for ~4 blocks per SM."""
    tiles = -(-cin // 16) * -(-cout // 64)
    pixel_tiles = B * T * -(-H // 8) * -(-W // 8)
    return max(1, min(pixel_tiles, -(-4 * _sm_count(device) // tiles)))


class ResnetBwdPlan(NamedTuple):
    """How the bf16 kernel 7 runs a block (``resnet_bwd_plan``)."""
    recompute: ResnetPlan  # the forward's convs again: kernel 3's channels, grids, rings, tiles
    splits1: int           # pixel splits of dW1, dW2 and dWres (``wgrad_splits``): each
    splits2: int           #   gradient launch's dW blocks, TAPS x splits x tiles of 128 x 128
    splits_r: int          #   (1 without a residual projection)
    grad_blocks: tuple     # blocks of the conv2, conv1 and residual gradient launches (din + dW)
    chunks: int            # pixel chunks of a sample in the GroupNorm sums
    gn_grid: tuple         # their blocks: (B x chunks, channel tiles of GN_PART_COLS)
    scratch: int           # bytes of the one scratch buffer (resnet_bwd_scratch_bytes)


GN_PART_COLS = 64     # channels of a GroupNorm-sums block (csrc/resnet.cu PART_COLS)
GN_MIN_ROWS = 64      # fewest pixel rows of a chunk
GN_BLOCKS_PER_SM = 4


def _grad_launch(pixels: int, cin: int, cout: int, taps: int, sms: int):
    """(splits, blocks) of one gradient launch (``bwd_wgmma_kernel``): din's
    pixel x Cin tiles and dW's TAPS x splits x Cin x Cout tiles."""
    ti, to = ceil_div(cin, CONV_TILE), ceil_div(cout, CONV_TILE)
    splits, _ = wgrad_splits(pixels, taps * ti * to, sms)
    return splits, ceil_div(pixels, CONV_TILE) * ti + taps * splits * ti * to


@functools.lru_cache(maxsize=512)
def resnet_bwd_plan(batch: int, pixels: int, cin: int, cout: int, groups: int, residual: bool,
                    film: bool, sms: int) -> ResnetBwdPlan:
    """The plan of the bf16 kernel 7 for a block of `batch` samples over
    `pixels` pixels in all, cin -> cout channels, with or without the
    residual projection and FiLM, on a card of `sms` SMs: the recompute as
    kernel 3 runs it (without the residual projection's tiles, which the
    backward does not need), the gradient launches' dW splits as kernel 11's
    (``conv33_plan``), the GroupNorm sums' chunks (about GN_BLOCKS_PER_SM
    blocks an SM, at least GN_MIN_ROWS rows a chunk), and the scratch's
    bytes from the source's ``resnet_bwd_scratch_bytes`` query."""
    if groups > MAX_GROUPS or cout % groups or pixels % batch:
        raise ValueError(f"resnet_bwd_plan: kernel 7 takes at most {MAX_GROUPS} groups dividing "
                         f"Cout and whole samples; got Cout={cout}, groups={groups}, "
                         f"{pixels} pixels in {batch} samples")
    rec = resnet_plan(pixels, cin, cout, False, sms)
    s1, b1 = _grad_launch(pixels, rec.cin, rec.cout, 9, sms)
    s2, b2 = _grad_launch(pixels, rec.cout, rec.cout, 9, sms)
    sr, br = _grad_launch(pixels, rec.cin, rec.cout, 1, sms) if residual else (1, 0)
    cols = ceil_div(rec.cout, GN_PART_COLS)
    per_sample = pixels // batch
    want = max(1, min(ceil_div(per_sample, GN_MIN_ROWS),
                      ceil_div(GN_BLOCKS_PER_SM * sms, batch * cols)))
    chunks = ceil_div(per_sample, ceil_div(per_sample, want))  # no empty chunk
    scratch = _build.query("resnet", "resnet_bwd_scratch_bytes", batch, pixels, rec.cin, rec.cout,
                           cout, groups, int(residual), int(film), s1, s2, sr, chunks)
    return ResnetBwdPlan(rec, s1, s2, sr, (b2, b1, br), chunks, (batch * chunks, cols), scratch)


def resnet_bwd_grad_shapes(B: int, cin: int, cout: int, residual: bool, film: bool):
    """The gradients the bf16 kernel 7 writes into its one float32 buffer,
    in order: (name, shape); the source's resnet_block_bwd_wgmma carves them."""
    shapes = [("w1", (cout, cin, 1, 3, 3)), ("w2", (cout, cout, 1, 3, 3))]
    shapes += [("wres", (cout, cin, 1, 1, 1))] if residual else []
    shapes += [(n, (cout,)) for n in ("b1", "g1s", "g1b", "b2", "g2s", "g2b")]
    shapes += [("bres", (cout,))] if residual else []
    return shapes + ([("film", (B, 2 * cout))] if film else [])


def resnet_block_bwd(g, x, w1, b1, g1s, g1b, film, w2, b2, g2s, g2b, wres=None, bres=None, *,
                     groups=8, eps=1e-5):
    """Kernel 7: (dx, dw1, db1, dg1s, dg1b, dfilm, dw2, db2, dg2s, dg2b, dwres,
    dbres) of ``fused_resnet_block`` at its inputs for the cotangent g; None
    for an absent operand, each gradient in its operand's dtype."""
    operands = (x, w1, b1, g1s, g1b, film, w2, b2, g2s, g2b, wres, bres)
    if x.device.type == "cpu":
        return resnet_block_plain_vjp(g, *operands, groups=groups, eps=eps)
    _check_block("resnet_block_bwd", *operands, groups)
    if not _bwd_takes(w1.shape[0], groups, x.dtype):
        raise ValueError(f"resnet_block_bwd: kernel 7 takes at most {MAX_GROUPS} groups dividing "
                         f"Cout, in float32 Cout <= {BWD_F32_MAX_COUT}; got Cout={w1.shape[0]}, "
                         f"groups={groups}, {x.dtype}")
    if g.device != x.device or tuple(g.shape) != tuple(x.shape[:4]) + (w1.shape[0],):
        raise ValueError(f"resnet_block_bwd: cotangent {tuple(g.shape)} on {g.device}")
    if x.dtype == torch.bfloat16:
        grads = _resnet_bwd_wgmma(g, *operands, groups=groups, eps=eps)
    else:
        grads = _resnet_bwd_f32(g, *operands, groups=groups, eps=eps)
    resnet_block_bwd.launches += 1
    return tuple(None if t is None else d.to(t.dtype) for d, t in zip(grads, operands))


def _resnet_bwd_wgmma(g, x, w1, b1, g1s, g1b, film, w2, b2, g2s, g2b, wres, bres, *, groups,
                      eps):
    """Kernel 7 in bf16 (resnet.cu resnet_block_bwd_wgmma), which casts the
    parameters into its one scratch buffer as kernel 3 does: three
    allocations (scratch, dx, one float32 buffer of every other gradient)
    and one launch call from here."""
    B, T, H, W, Cin = x.shape
    Cout = w1.shape[0]
    pixels = B * T * H * W
    residual, has_film = wres is not None, film is not None
    plan = resnet_bwd_plan(B, pixels, Cin, Cout, groups, residual, has_film, _sm_count(x.device))
    rec = plan.recompute
    xp = _padded(x.detach().reshape(pixels, Cin), rec.cin)
    gp = _padded(g.detach().to(torch.bfloat16).reshape(pixels, Cout), rec.cout)
    w1c, w2c, wrc, b1c, g1sc, g1bc, b2c, g2sc, g2bc, filmc = (
        None if t is None else t.detach().contiguous()
        for t in (w1, w2, wres, b1, g1s, g1b, b2, g2s, g2b, film))
    scratch = torch.empty(plan.scratch, dtype=torch.uint8, device=x.device)
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)  # written row-major
    shapes = resnet_bwd_grad_shapes(B, Cin, Cout, residual, has_film)
    flat = torch.empty(sum(math.prod(s) for _, s in shapes), dtype=torch.float32, device=x.device)
    P = _build.ptr
    _build.launch("resnet", "resnet_block_bwd_wgmma", P(xp), P(gp), P(w1c), P(w2c), P(wrc),
                  _code(w1c, w2c, wrc), P(b1c), P(g1sc), P(g1bc), P(b2c), P(g2sc), P(g2bc),
                  _code(b1c, g1sc, g1bc, b2c, g2sc, g2bc), P(filmc),
                  0 if film is None else _code(filmc), P(scratch), plan.scratch, P(dx), P(flat),
                  B, T, H, W, Cin, Cout, rec.cin, rec.cout, groups, eps, rec.stages1,
                  rec.stages2, rec.bn, plan.splits1, plan.splits2, plan.splits_r, plan.chunks,
                  _build.stream(x))
    views, at = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        views[name] = flat[at:at + n].view(shape)
        at += n
    return (dx, *(views.get(n) for n in ("w1", "b1", "g1s", "g1b", "film", "w2", "b2", "g2s",
                                         "g2b", "wres", "bres")))


def _resnet_bwd_f32(g, x, w1, b1, g1s, g1b, film, w2, b2, g2s, g2b, wres, bres, *, groups, eps):
    """Kernel 7 in float32, the check path (resnet.cu resnet_block_bwd)."""
    B, T, H, W, Cin = x.shape
    Cout = w1.shape[0]
    dt = x.dtype
    operands = (x, w1, b1, g1s, g1b, film, w2, b2, g2s, g2b, wres, bres)
    x = x.detach().contiguous()
    gc = g.detach().to(dt).contiguous()
    (w1c, w2c, wresc), (b1c, g1sc, g1bc, filmc, b2c, g2sc, g2bc, _) = _converted(*operands)
    # dgrad weights: flipped in (kh, kw), transposed to (Cin', Cout') = (Cin, Cout)
    w1f = w1c.flip(-1, -2).transpose(0, 1).contiguous()
    w2f = w2c.flip(-1, -2).transpose(0, 1).contiguous()
    wresf = None if wres is None else wresc.flatten(1).t().contiguous()
    out_shape, in_shape = (B, T, H, W, Cout), (B, T, H, W, Cin)
    y1, y2, a1, dy2, da1, dy1 = (torch.empty(out_shape, dtype=dt, device=x.device)
                                 for _ in range(6))
    dx1, dxo = torch.empty(in_shape, dtype=dt, device=x.device), torch.empty_like(x)
    dres = None if wres is None else torch.empty_like(x)
    f32 = dict(dtype=torch.float32, device=x.device)
    stats = torch.zeros((2, B, groups, 2), dtype=torch.float64, device=x.device)
    sums = torch.zeros((2, B, Cout, 2), dtype=torch.float64, device=x.device)
    coef = torch.empty((2, B, groups, 2), **f32)
    s1 = _wgrad_splits(B, T, H, W, Cin, Cout, x.device)
    s2 = _wgrad_splits(B, T, H, W, Cout, Cout, x.device)
    sr = _wgrad_splits(B, T, H, W, Cin, Cout, x.device) if wres is not None else 1
    part_w = torch.empty(max(s1 * Cout * Cin * 9, s2 * Cout * Cout * 9, sr * Cout * Cin), **f32)
    part_b = torch.empty(max(s1, s2, sr) * Cout, **f32)
    dw1, dw2 = torch.empty((Cout, Cin, 1, 3, 3), **f32), torch.empty((Cout, Cout, 1, 3, 3), **f32)
    db1, dg1s, dg1b, db2, dg2s, dg2b = (torch.empty(Cout, **f32) for _ in range(6))
    dfilm = None if film is None else torch.empty((B, 2 * Cout), **f32)
    dwres = None if wres is None else torch.empty((Cout, Cin, 1, 1, 1), **f32)
    dbres = None if wres is None else torch.empty(Cout, **f32)
    P = _build.ptr
    _build.launch("resnet", "resnet_block_bwd", _build.dtype_code(dt),
                  P(x), P(gc), P(w1c), P(w1f), P(b1c), P(g1sc), P(g1bc), P(filmc), P(w2c), P(w2f),
                  P(b2c), P(g2sc), P(g2bc), P(wresf), P(y1), P(y2), P(a1), P(dy2), P(da1), P(dy1),
                  P(dx1), P(dres), P(stats), P(sums), P(coef), P(part_w), P(part_b), P(dxo),
                  P(dw1), P(db1), P(dg1s), P(dg1b), P(dfilm), P(dw2), P(db2), P(dg2s), P(dg2b),
                  P(dwres), P(dbres), B, T, H, W, Cin, Cout, groups, eps, s1, s2, sr,
                  _build.stream(x))
    return dxo, dw1, db1, dg1s, dg1b, dfilm, dw2, db2, dg2s, dg2b, dwres, dbres


resnet_block_bwd.launches = 0


def resnet_block_plain_vjp(g, x, w1, b1, g1s, g1b, film, w2, b2, g2s, g2b, wres=None, bres=None,
                           **kwargs):
    """The plain version of kernel 7: autograd of ``resnet_block_plain``."""
    return plain_vjp(resnet_block_plain, g, x, w1, b1, g1s, g1b, film, w2, b2, g2s, g2b, wres,
                     bres, **kwargs)


# ------------------------------------------------- kernels 10 and 11: the conv
def _conv_weight(w: torch.Tensor) -> torch.Tensor:
    """(9, Cin, Cout) taps in (ky, kx) order -> torch Conv2d (Cout, Cin, 3, 3)."""
    return w.reshape(3, 3, w.shape[1], w.shape[2]).permute(3, 2, 0, 1)


def taps(w: torch.Tensor) -> torch.Tensor:
    """torch Conv3d (Cout, Cin, 1, 3, 3) -> (9, Cin, Cout) taps in (ky, kx) order."""
    return w[:, :, 0].permute(2, 3, 1, 0).reshape(9, w.shape[1], w.shape[0])


def conv33_plain(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """The semantics of ``pallas_resnet._conv33_fwd``: x (B, T, H, W, Cin)
    and w (9, Cin, Cout) in x.dtype, products summed in float32, returns
    float32 (B, T, H, W, Cout) = conv(1,3,3)(x) + b with zero edges."""
    B, T, H, W, Cin = x.shape
    y = F.conv2d(x.reshape(B * T, H, W, Cin).permute(0, 3, 1, 2).float(),
                 _conv_weight(w.to(x.dtype).float()), None if b is None else b.float(), padding=1)
    return y.permute(0, 2, 3, 1).reshape(B, T, H, W, -1)


def _check_conv(what, a, w, *others):
    devices = {str(t.device) for t in (w, *others) if t is not None}
    if not a.is_cuda or devices != {str(a.device)}:
        raise ValueError(f"{what}: kernel wrappers take CPU or CUDA tensors on one device, got "
                         f"{a.device} and {sorted(devices)}")
    if w.ndim != 3 or w.shape[0] != 9 or w.shape[1] != a.shape[-1]:
        raise ValueError(f"{what}: w has shape {tuple(w.shape)}, expected (9, {a.shape[-1]}, Cout)")


class ConvPlan(NamedTuple):
    """How the bf16 kernels 10 and 11 run one conv (``conv33_plan``)."""
    cin: int                 # channel counts the kernels see: zero-padded up to a
    cout: int                #   multiple of CONV_CHANNEL_ALIGN
    fwd_grid: tuple          # kernel 10's blocks: (pixel tiles, Cout tiles)
    din_grid: tuple          # kernel 11's input gradient: (pixel tiles, Cin tiles)
    wgrad_grid: tuple        # its dW: (Cin tiles, Cout tiles, 9 taps x splits)
    splits: int              # dW: the pixels in `splits` ranges of `per` steps of
    per: int                 #   CONV_STEP pixels, in order; the last may be short
    smem: int                # dynamic shared memory of a block, bytes


@functools.lru_cache(maxsize=512)
def conv33_plan(pixels: int, cin: int, cout: int, sms: int) -> ConvPlan:
    """The plan of the bf16 kernels for a conv over `pixels` pixels, cin ->
    cout channels, on a card of `sms` SMs. Channels that are not a multiple of
    CONV_CHANNEL_ALIGN are padded with zeros (the wrapper pads, the kernels
    compute on the zeros, the wrapper slices). dW's pixel splits
    (``wgrad_splits``: KTH's 64-channel levels need many, 9 tiles over
    245,760 pixels)."""
    cin_p, cout_p = (ceil_div(c, CONV_CHANNEL_ALIGN) * CONV_CHANNEL_ALIGN for c in (cin, cout))
    rows = ceil_div(pixels, CONV_TILE)
    ti, to = ceil_div(cin_p, CONV_TILE), ceil_div(cout_p, CONV_TILE)
    splits, per = wgrad_splits(pixels, 9 * ti * to, sms)
    return ConvPlan(cin_p, cout_p, (rows, to), (rows, ti), (ti, to, 9 * splits), splits, per,
                    CONV_SMEM)


def _padded(t: torch.Tensor, *sizes: int) -> torch.Tensor:
    """t with its trailing dims zero-padded up to `sizes`, contiguous and
    16-byte aligned (t itself when it already is)."""
    pads = []
    for have, want in zip(reversed(t.shape), reversed(sizes)):
        pads += [0, want - have]
    if any(pads):
        t = F.pad(t, pads)
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def conv33_fwd_operands(x, w, b, plan: ConvPlan):
    """x (pixels, plan.cin) and w (9, plan.cin, plan.cout) in x.dtype, b
    float32 (plan.cout) or None: the operands of the bf16 kernel 10, channels
    zero-padded."""
    x2 = _padded(x.detach().reshape(-1, x.shape[-1]), plan.cin)
    wp = _padded(w.detach().to(x.dtype), plan.cin, plan.cout)
    bp = None if b is None else _padded(b.detach().float(), plan.cout)
    return x2, wp, bp


def conv33_bwd_operands(da, a_in, w, plan: ConvPlan):
    """da (pixels, plan.cout), a_in (pixels, plan.cin) and w (9, plan.cin,
    plan.cout), all in a_in.dtype: the operands of the bf16 kernel 11,
    channels zero-padded."""
    dt = a_in.dtype
    dap = _padded(da.detach().to(dt).reshape(-1, da.shape[-1]), plan.cout)
    ap = _padded(a_in.detach().reshape(-1, a_in.shape[-1]), plan.cin)
    wp = _padded(w.detach().to(dt), plan.cin, plan.cout)
    return dap, ap, wp


def conv33_fwd(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """Kernel 10; same arguments and result as ``conv33_plain``."""
    if x.device.type == "cpu":
        return conv33_plain(x, w, b)
    _check_conv("conv33_fwd", x, w, b)
    B, T, H, W, Cin = x.shape
    Cout = w.shape[-1]
    if b is not None and tuple(b.shape) != (Cout,):
        raise ValueError(f"conv33_fwd: b has shape {tuple(b.shape)}, expected ({Cout},)")
    code, dev = _build.dtype_code(x.dtype), x.device
    if x.dtype == torch.bfloat16:
        plan = conv33_plan(B * T * H * W, Cin, Cout, _sm_count(dev))
        xc, wc, bc = conv33_fwd_operands(x, w, b, plan)
        Cin, Cout = plan.cin, plan.cout
    else:
        xc = x.detach().contiguous()
        wc = w.detach().to(x.dtype).contiguous()
        bc = None if b is None else b.detach().float().contiguous()
    out = torch.empty((B, T, H, W, Cout), dtype=torch.float32, device=dev)
    P = _build.ptr
    _build.launch("conv33", "conv33_fwd", code, P(xc), P(wc), P(bc), P(out), B * T, H, W, Cin,
                  Cout, _build.stream(x))
    conv33_fwd.launches += 1
    return out if Cout == w.shape[-1] else out[..., :w.shape[-1]].contiguous()


conv33_fwd.launches = 0


def conv33_bwd_plain(da: torch.Tensor, a_in: torch.Tensor, w: torch.Tensor):
    """The semantics of ``pallas_resnet._conv33_bwd``: da (B, T, H, W, Cout)
    rounded to a_in's dtype, products in float32; returns float32 din (B, T,
    H, W, Cin) and dW (9, Cin, Cout)."""
    with torch.enable_grad():
        a32 = a_in.detach().float().requires_grad_(True)
        w32 = w.detach().to(a_in.dtype).float().requires_grad_(True)
        out = conv33_plain(a32, w32, None)
        din, dw = torch.autograd.grad(out, (a32, w32), da.detach().to(a_in.dtype).float())
    return din, dw


def _conv_splits(pixels: int, cin: int, cout: int, device) -> int:
    """Splits over pixels of the float32 dW product, for ~4 blocks per SM."""
    tiles = 9 * -(-cin // 64) * -(-cout // 64)
    return max(1, min(-(-pixels // 32), -(-4 * _sm_count(device) // tiles)))


def conv33_bwd(da: torch.Tensor, a_in: torch.Tensor, w: torch.Tensor):
    """Kernel 11; same arguments and results as ``conv33_bwd_plain``."""
    if a_in.device.type == "cpu":
        return conv33_bwd_plain(da, a_in, w)
    _check_conv("conv33_bwd", a_in, w, da)
    B, T, H, W, Cin = a_in.shape
    Cout = w.shape[-1]
    if tuple(da.shape) != (B, T, H, W, Cout):
        raise ValueError(f"conv33_bwd: da has shape {tuple(da.shape)}, expected "
                         f"{(B, T, H, W, Cout)}")
    f32 = dict(dtype=torch.float32, device=a_in.device)
    if a_in.dtype == torch.bfloat16:
        plan = conv33_plan(B * T * H * W, Cin, Cout, _sm_count(a_in.device))
        dac, ac, wc = conv33_bwd_operands(da, a_in, w, plan)
        Cin, Cout, splits = plan.cin, plan.cout, plan.splits
        part = None if splits == 1 else torch.empty(splits * 9 * Cin * Cout, **f32)
    else:
        dac = da.detach().to(a_in.dtype).contiguous()
        ac = a_in.detach().contiguous()
        wc = w.detach().to(a_in.dtype).contiguous()
        splits = _conv_splits(B * T * H * W, Cin, Cout, a_in.device)
        part = torch.empty(splits * 9 * Cin * Cout, **f32)
    din = torch.empty((B, T, H, W, Cin), **f32)
    dw = torch.empty((9, Cin, Cout), **f32)
    P = _build.ptr
    _build.launch("conv33", "conv33_bwd", _build.dtype_code(a_in.dtype), P(dac), P(ac), P(wc),
                  P(din), P(part), P(dw), B * T, H, W, Cin, Cout, splits, _build.stream(a_in))
    conv33_bwd.launches += 1
    cin, cout = a_in.shape[-1], w.shape[-1]
    if (Cin, Cout) != (cin, cout):
        din, dw = din[..., :cin].contiguous(), dw[:, :cin, :cout].contiguous()
    return din, dw


conv33_bwd.launches = 0


# ------------------------------------------------- the decomposed backward
def _group_stats(a: torch.Tensor, groups: int, eps: float):
    """Group mean and rstd of a float32 (B, T, H, W, C), broadcast back to
    channels (``pallas_resnet._gn_stats_xla``)."""
    B, C = a.shape[0], a.shape[-1]
    g = a.reshape(B, -1, groups, C // groups)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = ((g - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    return _per_channel(mean, C), _per_channel(torch.rsqrt(var + eps), C)


def _per_channel(t: torch.Tensor, C: int) -> torch.Tensor:
    """(B, 1, groups, 1) -> (B, 1, 1, 1, C), each group's value on its channels."""
    B, groups = t.shape[0], t.shape[2]
    return t.reshape(B, groups, 1).expand(B, groups, C // groups).reshape(B, 1, 1, 1, C)


def _group_mean(t: torch.Tensor, groups: int) -> torch.Tensor:
    """Per-(b, group) mean broadcast back to channels (``_gmean_xla``)."""
    B, C = t.shape[0], t.shape[-1]
    return _per_channel(t.reshape(B, -1, groups, C // groups).mean(dim=(1, 3), keepdim=True), C)


def _dsilu(u: torch.Tensor, sig: torch.Tensor) -> torch.Tensor:
    return sig * (1.0 + u * (1.0 - sig))


def resnet_block_bwd_decomposed(g, x, w1, b1, g1s, g1b, film, w2, b2, g2s, g2b, wres=None,
                                bres=None, *, groups=8, eps=1e-5):
    """The gradients of ``fused_resnet_block`` as ``resnet_block_bwd`` returns
    them, by ``pallas_resnet._chunked_bwd``: the forward recomputed with
    kernel 10 (a1, a2 in float32), each conv's gradients by kernel 11, the
    GroupNorm, FiLM and SiLU chains and the per-channel sums in torch, in
    float32. On CPU tensors the convs are their plain versions."""
    f32 = torch.float32
    dtype = x.dtype
    Cin, Cout = x.shape[-1], w1.shape[0]
    w1c, w2c = taps(w1.detach()).to(dtype), taps(w2.detach()).to(dtype)  # cast once for both convs
    x = x.detach()
    vec = lambda t: t.detach().to(f32)  # noqa: E731

    # ---- the forward again: convs by kernel 10, the rest in torch
    a1 = conv33_fwd(x, w1c, b1.detach())
    mean1, rstd1 = _group_stats(a1, groups, eps)
    n1 = (a1 - mean1) * rstd1
    y1 = n1 * vec(g1s) + vec(g1b)
    if film is not None:
        fs, fb = (t[:, None, None, None, :] for t in vec(film).chunk(2, dim=-1))
        y1f = y1 * (fs + 1.0) + fb
    else:
        y1f = y1
    sig1 = torch.sigmoid(y1f)
    h1c = (y1f * sig1).to(dtype)
    a2 = conv33_fwd(h1c, w2c, b2.detach())
    mean2, rstd2 = _group_stats(a2, groups, eps)
    n2 = (a2 - mean2) * rstd2
    del a1, a2

    # ---- backward
    gf = g.detach().to(f32)
    y2 = n2 * vec(g2s) + vec(g2b)
    dy2 = gf * _dsilu(y2, torch.sigmoid(y2))
    dims = (0, 1, 2, 3)
    dg2s, dg2b = (dy2 * n2).sum(dims), dy2.sum(dims)
    dn2 = dy2 * vec(g2s)
    da2 = rstd2 * (dn2 - _group_mean(dn2, groups) - n2 * _group_mean(dn2 * n2, groups))
    db2 = da2.sum(dims)
    dh1, dw2 = conv33_bwd(da2, h1c, w2c)
    del da2, dn2, dy2, y2, n2, h1c

    dy1f = dh1 * _dsilu(y1f, sig1)
    dfilm = None
    if film is not None:
        dfilm = torch.cat([(dy1f * y1).sum((1, 2, 3)), dy1f.sum((1, 2, 3))], dim=-1)
        dy1 = dy1f * (fs + 1.0)
    else:
        dy1 = dy1f
    dg1s, dg1b = (dy1 * n1).sum(dims), dy1.sum(dims)
    dn1 = dy1 * vec(g1s)
    da1 = rstd1 * (dn1 - _group_mean(dn1, groups) - n1 * _group_mean(dn1 * n1, groups))
    db1 = da1.sum(dims)
    dx, dw1 = conv33_bwd(da1, x, w1c)

    dwres = dbres = None
    if wres is not None:
        gc = g.detach().to(dtype)
        wr = wres.detach().to(dtype).flatten(1)  # (Cout, Cin)
        dx = dx + (gc @ wr).to(f32)
        dwres = (gc.reshape(-1, Cout).t() @ x.reshape(-1, Cin)).reshape(Cout, Cin, 1, 1, 1)
        dbres = gf.sum(dims)
    else:
        dx = dx + gf
    conv_grad = lambda dw: dw.reshape(3, 3, -1, Cout).permute(3, 2, 0, 1).unsqueeze(2)  # noqa: E731
    grads = (dx, conv_grad(dw1), db1, dg1s, dg1b, dfilm, conv_grad(dw2), db2, dg2s, dg2b, dwres,
             dbres)
    operands = (x, w1, b1, g1s, g1b, film, w2, b2, g2s, g2b, wres, bres)
    return tuple(None if t is None else d.to(t.dtype) for d, t in zip(grads, operands))
