"""Kernel 3 of the sampling path: the whole ResnetBlock3d (``csrc/resnet.cu``).

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
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from extdm_tpu_torch import _build

__all__ = ["fused_resnet_block", "resnet_block_plain"]


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


def fused_resnet_block(x, w1, b1, g1s, g1b, film: Optional[torch.Tensor], w2, b2, g2s, g2b,
                       wres=None, bres=None, *, groups=8, eps=1e-5):
    """Whole ResnetBlock3d; same arguments and result as ``resnet_block_plain``."""
    if x.device.type == "cpu":
        return resnet_block_plain(x, w1, b1, g1s, g1b, film, w2, b2, g2s, g2b, wres, bres,
                                  groups=groups, eps=eps)
    operands = [t for t in (w1, b1, g1s, g1b, film, w2, b2, g2s, g2b, wres, bres) if t is not None]
    if not x.is_cuda or any(t.device != x.device for t in operands):
        raise ValueError(f"fused_resnet_block: activation on {x.device}, operands on "
                         f"{sorted({str(t.device) for t in operands})}")
    B, T, H, W, Cin = x.shape
    Cout = w1.shape[0]
    if groups > 32 or Cout % groups:
        raise ValueError(f"fused_resnet_block: {Cout} channels in {groups} groups")
    if (wres is None) != (Cin == Cout):
        raise ValueError("fused_resnet_block: a residual projection is needed iff Cin != Cout")
    shapes = {"w1": (w1, (Cout, Cin, 1, 3, 3)), "w2": (w2, (Cout, Cout, 1, 3, 3)),
              "film": (film, (B, 2 * Cout)), "wres": (wres, (Cout, Cin, 1, 1, 1))}
    shapes.update({n: (t, (Cout,)) for n, t in
                   (("b1", b1), ("g1s", g1s), ("g1b", g1b), ("b2", b2), ("g2s", g2s),
                    ("g2b", g2b), ("bres", bres))})
    for name, (t, shape) in shapes.items():
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"fused_resnet_block: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    dt = x.dtype
    x = x.contiguous()
    # converted operands stay referenced until the launch has been queued
    weights = [None if t is None else t.detach().to(dt).contiguous() for t in (w1, w2, wres)]
    vectors = [None if t is None else t.detach().float().contiguous()
               for t in (b1, g1s, g1b, film, b2, g2s, g2b, bres)]
    w1c, w2c, wresc = weights
    b1c, g1sc, g1bc, filmc, b2c, g2sc, g2bc, bresc = vectors
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


fused_resnet_block.launches = 0
