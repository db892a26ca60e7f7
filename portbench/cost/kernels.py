"""Operations and bytes of the program's kernel entry points, from the
shapes of their arguments, and the least time the card could take for them.

Each ``*_cost`` takes the arguments of one call of an entry point as the
program passes them (``fused_stw_layer``, ``fused_temporal_layer``,
``fused_resnet_block``, ``grid_sample`` and the backward entries
``stw_layer_bwd``, ``temporal_layer_bwd``, ``resnet_block_bwd``), or of
a module's ``forward`` (``trajwarp_cost``: ``TrajWarp``), and returns
(bytes, flops, dtype): every input byte read once and every output byte
written once, and the products the layer needs. They are frozen copies of
the cost model the kernels were tuned against (``trajwarp_cost``: counted
from the published layer), so that a change to the program cannot move its
own yardstick.
"""
from __future__ import annotations

import math

import torch

# One H100 SXM at 700 W (NVIDIA's data sheet): dense flop/s by operand type
# and HBM bytes/s.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound_seconds(byts: float, flops: float, dtype) -> float:
    """The least time: the larger of the flops at the peak and the bytes at HBM's rate."""
    return max(flops / PEAK_FLOPS[dtype], byts / HBM_BYTES_PER_S)


def share(bound_s: float, device_s: float):
    """A bound's share of a measured time in percent; None where nothing was measured.
    A time shorter than its bound is a fault of the counting or of the timing."""
    if device_s <= 0:
        return None
    if device_s < bound_s:
        raise ValueError(f"measured {device_s} s under its bound {bound_s} s")
    return 100.0 * bound_s / device_s


def warp_cost(image, grid, padding_mode="zeros"):
    """Bilinear grid sample: image and grid read, output written; 8 flops an
    output value (three lerps) in float32."""
    B, Ho, Wo, _ = grid.shape
    out = B * Ho * Wo * image.shape[-1]
    byts = image.numel() * image.element_size() + grid.numel() * 4 + out * image.element_size()
    return byts, 8 * out, torch.float32


def stw_cost(x, gamma, w_qkv, w_proj, b_proj, bias, *, window, shift, heads, dim_head, **_):
    """Window attention layer: the qkv and output projections and, per real
    token, its scores and values against the N keys of its window (pad
    tokens are zeros whose outputs are cropped, so they count nothing)."""
    C = x.shape[-1]
    n, N, hid = x.numel() // C, math.prod(window), heads * dim_head
    flops = 2 * n * C * 3 * hid + 4 * n * N * hid + 2 * n * hid * C
    byts = (2 * x.numel() + w_qkv.numel() + w_proj.numel()) * x.element_size() + bias.numel() * 4
    return byts, flops, x.dtype


def temporal_cost(x, gamma_cln, ln_scale, ln_bias, w_qkv, w_out, bias, *, heads, dim_head, **_):
    """Attention over time: the projections and each token's T scores and values."""
    B, T, H, W, C = x.shape
    n, hid = x.numel() // C, heads * dim_head
    flops = 2 * n * C * 3 * hid + 4 * n * T * hid + 2 * n * hid * C
    byts = (2 * x.numel() + w_qkv.numel() + w_out.numel()) * x.element_size() + bias.numel() * 4
    return byts, flops, x.dtype


def resnet_cost(x, w1, b1, g1s, g1b, film, w2, b2, g2s, g2b, wres=None, bres=None, **_):
    """Resnet block: two 3x3 convolutions and the 1x1 residual projection."""
    B, T, H, W, Cin = x.shape
    P, Cout = B * T * H * W, w1.shape[0]
    flops = 2 * P * 9 * (Cin * Cout + Cout * Cout)
    if wres is not None:
        flops += 2 * P * Cin * Cout
    weights = w1.numel() + w2.numel() + (wres.numel() if wres is not None else 0)
    byts = (x.numel() + P * Cout + weights) * x.element_size()
    return byts, flops, x.dtype


def trajwarp_cost(xp, f, *, heads, **_):
    """The trajwarp family's feature warp (``TrajWarp.forward(xp, f)``):
    the q projection of the nq = B tp h w pooled prediction tokens, the k
    and v projections of the nk = B tc h w cond tokens, each query's scores
    and values against its row's tc h w keys, the output projection and the
    1x1x1 fuser from 2C to C; xp, f and the weights read once, the output
    (f's shape) written once. The 2x2 max-pool is bytes only."""
    B, tp = xp.shape[:2]
    _, T, h, w, C = f.shape
    if C % heads:
        raise ValueError(f"{C} channels do not split into {heads} heads")
    nq, nk = B * tp * h * w, B * (T - tp) * h * w
    flops = (2 * nq * C * C + 4 * nk * C * C + 4 * B * (tp * h * w) * ((T - tp) * h * w) * C
             + 2 * nq * C * C + 4 * nq * C * C)
    weights = 4 * (C * C + C) + 2 * C * C + C
    byts = (xp.numel() + weights + f.numel()) * xp.element_size() + f.numel() * f.element_size()
    return byts, flops, xp.dtype


FORWARD = {"stw_layer": stw_cost, "temporal_layer": temporal_cost,
           "resnet_block": resnet_cost, "grid_sample": warp_cost}


def grad_cost(name: str):
    """The cost of the backward entry of forward layer `name`, called as
    (cotangent, *forward arguments): one recompute of the forward's
    products and two products (input and weight gradients) per forward
    product, less the attention output projection's recompute (its output
    feeds only the residual sum); bytes of x, g and dx once each, the
    weights and their float32 gradients, the bias table and its gradient."""
    forward = FORWARD[name]

    def cost(g, x, *args, **kw):
        byts, flops, dtype = forward(x, *args, **kw)
        flops *= 3
        if name in ("stw_layer", "temporal_layer"):
            flops -= 2 * (x.numel() // x.shape[-1]) * kw["heads"] * kw["dim_head"] * x.shape[-1]
        weights = [t for t in args if torch.is_tensor(t) and t.ndim >= 2]
        extra = x.numel() * x.element_size() + sum(t.numel() * 4 for t in weights)
        return byts + extra, flops, dtype
    return cost


BACKWARD = {f"{name}_bwd": grad_cost(name) for name in ("stw_layer", "temporal_layer",
                                                         "resnet_block")}
