"""Constants and cost model of the wgmma engine in ``csrc/conv_ring.cuh``,
shared by the plans of the kernels built on it: kernels 10 and 11
(``conv33_plan``), kernel 3 (``resnet_plan``) and kernel 5's weight
gradients (``fused_stw``).

A block owns a CONV_TILE x CONV_TILE float32 tile (GM, GN in the source);
the reduction steps by CONV_STEP bf16 values (GK: one 128-byte swizzle row)
through a ring of shared-memory stages (STAGES), one A and one B tile each,
and an 8-byte mbarrier.
"""
from __future__ import annotations

CONV_TILE = 128
CONV_STEP = 64
CONV_STAGES = 5
CONV_CHANNEL_ALIGN = 8  # 16-byte rows: what cp.async and TMA copy
SMEM_PER_BLOCK = 232448  # the H100's most dynamic shared memory a block may take
# The weight-gradient split's cost model: a block's reduction step on an SM
# of its own (128 x 128 x 64 products, ~0.3 us at the bf16 peak) against
# HBM bytes of the partials that a split adds.
STEP_US = 0.4
HBM_BYTES_PER_US = 3.35e6


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def ring_smem(stages: int, bn: int = CONV_TILE) -> int:
    """conv_ring.cuh ring_smem: A and B tiles (CONV_TILE rows, bn columns)
    a stage, mbarriers, alignment."""
    return stages * (CONV_TILE + bn) * CONV_STEP * 2 + 8 * stages + 1024


CONV_SMEM = ring_smem(CONV_STAGES)


def wgrad_splits(pixels: int, tiles: int, sms: int):
    """(splits, per): the pixels (tokens) of a weight-gradient product of
    `tiles` blocks of 128 x 128 on the engine in `splits` ranges of `per`
    steps of CONV_STEP, minimising waves of blocks x steps per block plus
    the partials' bytes: one split when the tiles fill the card, more when a
    few tiles must fill it."""
    steps = max(1, ceil_div(pixels, CONV_STEP))
    best = None
    for want in range(1, min(steps, ceil_div(4 * sms, tiles)) + 1):
        per = ceil_div(steps, want)
        splits = ceil_div(steps, per)  # no empty split
        partial_bytes = (2 * splits + 1) * tiles * CONV_TILE * CONV_TILE * 4 if splits > 1 else 0
        cost = ceil_div(tiles * splits, sms) * per * STEP_US + partial_bytes / HBM_BYTES_PER_US
        if best is None or cost < best[0]:
            best = (cost, splits, per)
    return best[1], best[2]
