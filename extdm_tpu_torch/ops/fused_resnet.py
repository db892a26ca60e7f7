"""Kernel 3, the whole ResnetBlock3d, and its backward, kernel 7 (``csrc/resnet.cu``).

Replaces ``extdm_tpu/ops/pallas_resnet.py`` ``fused_resnet_block``
(``_kernel_impl`` -> ``_make_kernel``): conv(1,3,3)+b -> GroupNorm -> FiLM
``h (scale + 1) + shift`` -> SiLU -> conv(1,3,3)+b -> GroupNorm -> SiLU ->
+ x, or + a 1x1 residual projection.

On the H100 the two 3x3 convs bound it by operations; in bf16 they run on
the tensor cores. The JAX kernel holds a whole sample in VMEM so that
GroupNorm's statistics need no reduction across programs; an SM's shared
memory holds a small fraction of a sample, so the block runs as a short
sequence of this repo's kernels: each conv writes its output and adds
per-group sums into a float64 buffer, the next stage applies GroupNorm
(+ FiLM + SiLU) while it stages its input, and a last pass adds the
residual. The JAX VMEM gate (``pallas_resnet.supported``) has no
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
GroupNorms' scale and bias, dFiLM (B, 2 Cout) and the residual projection's)
in this file's kernels. The JAX VMEM gate (``pallas_resnet._bwd_supported``)
has no counterpart: every block takes the kernels. The plain backward is
``resnet_block_plain_vjp``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from extdm_tpu_torch import _build
from extdm_tpu_torch.ops.fused_stw import _needs_grad, _sm_count, plain_vjp

__all__ = ["fused_resnet_block", "resnet_block_plain", "resnet_block_bwd",
           "resnet_block_plain_vjp"]


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
    if groups > 32 or Cout % groups:
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


class _ResnetBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kw, x, *params):
        ctx.kw = kw
        ctx.save_for_backward(x, *params)
        return _resnet_forward(x, *params, **kw)

    @staticmethod
    def backward(ctx, g):
        return (None, *resnet_block_bwd(g, *ctx.saved_tensors, **ctx.kw))


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


def resnet_block_bwd(g, x, w1, b1, g1s, g1b, film, w2, b2, g2s, g2b, wres=None, bres=None, *,
                     groups=8, eps=1e-5):
    """Kernel 7: (dx, dw1, db1, dg1s, dg1b, dfilm, dw2, db2, dg2s, dg2b, dwres,
    dbres) of ``fused_resnet_block`` at its inputs for the cotangent g; None
    for an absent operand, each gradient in its operand's dtype."""
    operands = (x, w1, b1, g1s, g1b, film, w2, b2, g2s, g2b, wres, bres)
    if x.device.type == "cpu":
        return resnet_block_plain_vjp(g, *operands, groups=groups, eps=eps)
    _check_block("resnet_block_bwd", *operands, groups)
    if g.device != x.device or tuple(g.shape) != tuple(x.shape[:4]) + (w1.shape[0],):
        raise ValueError(f"resnet_block_bwd: cotangent {tuple(g.shape)} on {g.device}")
    B, T, H, W, Cin = x.shape
    Cout = w1.shape[0]
    dt = x.dtype
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
    resnet_block_bwd.launches += 1
    grads = (dxo, dw1, db1, dg1s, dg1b, dfilm, dw2, db2, dg2s, dg2b, dwres, dbres)
    return tuple(None if t is None else d.to(t.dtype) for d, t in zip(grads, operands))


resnet_block_bwd.launches = 0


def resnet_block_plain_vjp(g, x, w1, b1, g1s, g1b, film, w2, b2, g2s, g2b, wres=None, bres=None,
                           **kwargs):
    """The plain version of kernel 7: autograd of ``resnet_block_plain``."""
    return plain_vjp(resnet_block_plain, g, x, w1, b1, g1s, g1b, film, w2, b2, g2s, g2b, wres,
                     bres, **kwargs)
