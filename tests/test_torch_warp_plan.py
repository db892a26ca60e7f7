"""Kernels 4 and 8 (``csrc/grid_sample.cu``) on the CPU: the launch plan of
the grid sample and its backward, and the CPU wrappers.

``grid_sample_plan`` at the KTH sampler's, the eval call's and the AE step's
shapes and at chip_smoke's ``WARP_RAGGED``: every output pixel in exactly one
tile, the shared memory within a block's 232,448 bytes, vectors only as wide
as C x element size and the operands' alignment allow, kernel 8's lanes a
pixel, 32-bit indices within a sample and 64-bit bases past 2^31 bytes; the
source's ``grid_sample_smem`` query (stood in by a fixture that mirrors the
formula the source states) and its declaration. On the CPU the wrappers run
the plain versions and honour ``image_grad`` / ``grid_grad``. On the clamp
and fold lines, the plain backward with kernel 8's rule (the border passes
the gradient strictly inside, as ``chip_smoke.py`` holds kernel 8 to it)
equals the JAX package's Pallas backward (``pallas_warp.grid_sample`` in
interpret mode); at a NaN point the plain backward's values are pinned.
"""
import ctypes
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extdm_tpu.ops import pallas_warp
from extdm_tpu_torch import _build
from extdm_tpu_torch.ops import fused_warp as fw

SMEM_PER_BLOCK = 232448
SMEM_PER_SM = 233472  # 228 KB, of which each resident block reserves 1 KB
SMS = 132
SOURCE = (_build.CSRC / "grid_sample.cu").read_text()


def _source_constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


@pytest.fixture
def queries(monkeypatch):
    """Stands in for the source's grid_sample_smem query (the pixels'
    records), checking its arguments."""
    assert ("return (long long)tile_pixels * (backward ? BWD_PIXEL_BYTES : FWD_PIXEL_BYTES);"
            in SOURCE)
    fwd, bwd = _source_constant("FWD_PIXEL_BYTES"), _source_constant("BWD_PIXEL_BYTES")

    def query(source, name, backward, tile_pixels):
        assert (source, name) == ("grid_sample", "grid_sample_smem")
        assert 0 < tile_pixels <= 1024 and backward in (0, 1)
        return tile_pixels * (bwd if backward else fwd)

    monkeypatch.setattr(_build, "query", query)
    fw.grid_sample_plan.cache_clear()
    yield
    fw.grid_sample_plan.cache_clear()


def test_source_constants_are_the_plans():
    assert _source_constant("FWD_PIXEL_BYTES") == fw.FWD_PIXEL_BYTES
    assert _source_constant("BWD_PIXEL_BYTES") == fw.BWD_PIXEL_BYTES
    assert _source_constant("GS_THREADS") == 256


def test_size_query_and_entries_declared():
    """The plan's one size query and the entries' 64-bit shared-bytes
    argument, as _build reads them from the source."""
    assert _build.size_queries("grid_sample") == {"grid_sample_smem": [ctypes.c_int] * 2}
    entries = _build.entry_points("grid_sample")
    assert set(entries) == {"grid_sample", "grid_sample_bwd"}
    for name, types in entries.items():
        params = re.search(rf'extern "C" int {name}\(([^)]*)\)', SOURCE).group(1).split(",")
        names = [p.split()[-1].lstrip("*") for p in params]
        assert types[names.index("smem")] is ctypes.c_longlong
        assert len(types) == (16 if name == "grid_sample" else 20)


# (image (B, H, W, C), grid (Ho, Wo), element bytes, backward)
SAMPLER = [((440, 32, 32, 3), (32, 32)), ((80, 64, 64, 67), (64, 64)),
           ((80, 16, 16, 256), (16, 16)), ((80, 32, 32, 128), (32, 32))]
EVAL = [((4 * s[0], *s[1:]), hw) for s, hw in SAMPLER]
AE_FORWARD = [((704, 32, 32, 3), (32, 32)), ((64, 64, 64, 67), (64, 64)),
              ((64, 16, 16, 256), (16, 16)), ((64, 32, 32, 128), (32, 32)),
              ((64, 64, 64, 3), (64, 64))]
AE_BACKWARD = [((64, 32, 32, 128), (32, 32)), ((64, 16, 16, 256), (16, 16)),
               ((64, 64, 64, 67), (64, 64)), ((704, 32, 32, 3), (32, 32))]
# chip_smoke.py WARP_RAGGED: (C, (B, H, W), (Ho, Wo))
WARP_RAGGED = [(1, (2, 128, 96), (37, 45)), (3, (2, 72, 72), (33, 41)), (5, (2, 72, 72), (41, 29)),
               (67, (2, 40, 40), (21, 19)), (130, (2, 40, 40), (23, 30)),
               (256, (1, 40, 40), (19, 21)), (512, (1, 40, 40), (13, 17))]
RAGGED = [((B, H, W, C), hw) for C, (B, H, W), hw in WARP_RAGGED]
CASES = ([(s, hw, 2, False) for s, hw in SAMPLER + EVAL]
         + [(s, hw, 4, False) for s, hw in AE_FORWARD]
         + [(s, hw, 4, True) for s, hw in AE_BACKWARD]
         + [(s, hw, es, bwd) for s, hw in RAGGED for es in (2, 4) for bwd in (False, True)])


def _widest_vec(C, es, align):
    return max(v for v in (1, 2, 4, 8) if v * es <= 16 and C % v == 0 and align % (v * es) == 0)


@pytest.mark.parametrize("shape,hw,es,backward", CASES)
def test_plan_covers_the_output_and_fits(queries, shape, hw, es, backward):
    B, H, W, C = shape
    Ho, Wo = hw
    plan = fw.grid_sample_plan(B, H, W, C, Ho, Wo, es, 16, SMS, backward)
    th, tw = plan.tile_h, plan.tile_w
    tp = th * tw
    assert tw & (tw - 1) == 0 and tp % 32 == 0 and fw.MIN_TILE <= tp <= 256
    # every output pixel of a sample in exactly one tile (ragged at the edges)
    tiles_x = -(-Wo // tw)
    seen = np.zeros((Ho, Wo), dtype=np.int64)
    for t in range(plan.tiles):
        ty, tx = divmod(t, tiles_x)
        seen[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw] += 1
    assert (seen == 1).all() and plan.tiles == tiles_x * -(-Ho // th)
    assert plan.blocks == B * plan.tiles
    # 64 pixels (256 where a pixel has few vectors or lanes), halved only
    # while the launch has too few blocks to fill the card
    nv = C // plan.vec
    if backward:
        tp0 = 256 if plan.lanes <= 4 else 64
    else:
        tp0 = 64 if nv >= 16 else (128 if nv >= 8 else 256)
    assert tp <= tp0
    if tp < tp0:
        w2 = 8 if 2 * tp <= 64 else 16
        assert B * -(-Ho // (2 * tp // w2)) * -(-Wo // w2) < fw.BLOCKS_PER_SM * SMS
    # vectors: the widest of at most 16 bytes that divides C and the alignment
    assert plan.vec == _widest_vec(C, es, 16)
    assert tp * nv < fw.MAX_TILE_VECTORS
    assert plan.smem <= SMEM_PER_BLOCK
    if backward:
        # a pixel's lanes: one where its channels take at most 16 bytes,
        # else a power of two up to 32 and C's vectors, reading at least 64
        # bytes a load where C allows, that idles the fewest lanes; where
        # two idle as few, the wider group
        most = min(32, 1 << (nv - 1).bit_length())
        least = min(most, max(1, 64 // (plan.vec * es)))
        L = plan.lanes
        if C * es <= 16:
            assert L == 1
        else:
            assert L & (L - 1) == 0 and least <= L <= most
            n = least
            while n <= most:
                assert L * -(-nv // L) < n * -(-nv // n) or (
                    L * -(-nv // L) == n * -(-nv // n) and L >= n)
                n *= 2
        assert plan.smem == tp * fw.BWD_PIXEL_BYTES
    else:
        assert plan.lanes == 0 and plan.smem == tp * fw.FWD_PIXEL_BYTES
    assert plan.image_elems == H * W * C < 2 ** 31 and plan.out_elems == Ho * Wo * C < 2 ** 31
    assert fw.grid_sample_plan(B, H, W, C, Ho, Wo, es, 16, SMS, backward) is plan


def test_plan_tiles_and_chunks_at_the_path_shapes(queries):
    """The decode warps' tiles: 8 x 8 at 64^2 and 32^2, 4 x 8 at 16^2 (too
    few 8 x 8 tiles to fill the card); the K+1 sparse warp's 16 x 16 (C = 3:
    a pixel a lane); 16-byte vectors at 128 and 256
    channels, one element at C = 67 and 3; kernel 8's C = 67 on 16 lanes a
    pixel in float32 (80 slots for 67 channels) and 32 in bf16."""
    p = fw.grid_sample_plan(80, 64, 64, 67, 64, 64, 2, 16, SMS)
    assert (p.tile_h, p.tile_w, p.vec, p.blocks) == (8, 8, 1, 80 * 64)
    p = fw.grid_sample_plan(80, 16, 16, 256, 16, 16, 2, 16, SMS)
    assert (p.tile_h, p.tile_w, p.vec) == (4, 8, 8)
    p = fw.grid_sample_plan(440, 32, 32, 3, 32, 32, 2, 16, SMS)
    assert (p.tile_h, p.tile_w, p.vec) == (16, 16, 1)
    p = fw.grid_sample_plan(64, 64, 64, 67, 64, 64, 4, 16, SMS, True)
    assert (p.tile_h, p.tile_w, p.vec, p.lanes, p.smem) == (8, 8, 1, 16, 64 * 64)
    assert fw.grid_sample_plan(64, 64, 64, 67, 64, 64, 2, 16, SMS, True).lanes == 32
    p = fw.grid_sample_plan(64, 32, 32, 128, 32, 32, 4, 16, SMS, True)
    assert (p.vec, p.lanes) == (4, 32)
    p = fw.grid_sample_plan(64, 16, 16, 256, 16, 16, 4, 16, SMS, True)
    assert (p.tile_h, p.tile_w, p.vec, p.lanes) == (4, 8, 4, 32)
    p = fw.grid_sample_plan(704, 32, 32, 3, 32, 32, 4, 16, SMS, True)
    assert (p.tile_h, p.tile_w, p.lanes) == (16, 16, 1)


@pytest.mark.parametrize("C,es,align,vec", [
    (256, 2, 16, 8), (256, 2, 8, 4), (256, 2, 4, 2), (256, 2, 2, 1),
    (128, 4, 16, 4), (128, 4, 8, 2), (128, 4, 4, 1),
    (130, 2, 16, 2), (130, 4, 16, 2), (67, 2, 16, 1), (3, 4, 16, 1), (12, 4, 16, 4),
])
def test_plan_vector_width_follows_channels_and_alignment(queries, C, es, align, vec):
    for backward in (False, True):
        assert fw.grid_sample_plan(2, 16, 16, C, 16, 16, es, align, SMS, backward).vec == vec


def test_align_reads_the_operands_addresses():
    x = torch.zeros(64, dtype=torch.float32)
    assert fw._align(x) == 16  # torch allocations are aligned far beyond 16 bytes
    assert fw._align(x[1:]) == 4 and fw._align(x[2:]) == 8 and fw._align(x[4:]) == 16
    assert fw._align(x, x[2:]) == 8
    y = torch.zeros(64, dtype=torch.bfloat16)
    assert fw._align(y[1:]) == 2 and fw._align(y[3:]) == 2 and fw._align(y[8:]) == 16


def test_plan_bases_past_2_31_bytes(queries):
    """A 100-trajectory evaluation batch: 4,000 decoded frames of 64 x 64 x 67
    bf16 are 2.2 GB, past 2^31 bytes; within a sample the indices stay
    32-bit, and the sample's base is 64-bit in the kernels."""
    B = 100 * 40
    plan = fw.grid_sample_plan(B, 64, 64, 67, 64, 64, 2, 16, SMS)
    assert B * plan.image_elems * 2 > 2 ** 31 and plan.image_elems < 2 ** 31
    assert plan.blocks == B * plan.tiles < 2 ** 31
    assert "(long long)b * g.H * g.W * g.C" in SOURCE and "(long long)b * g.Ho * g.Wo" in SOURCE


def test_plan_refusals(queries):
    with pytest.raises(ValueError, match="32-bit"):
        fw.grid_sample_plan(1, 32768, 32768, 4, 8, 8, 4, 16, SMS)
    with pytest.raises(ValueError, match="16 bits"):
        fw.grid_sample_plan(1, 8, 40000, 1, 8, 8, 4, 16, SMS, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["zeros", "border", "reflection"])
def test_cpu_wrappers_take_the_plain_versions(dtype, mode):
    rng = np.random.default_rng(5)
    image = torch.from_numpy(rng.normal(size=(2, 9, 7, 5)).astype(np.float32)).to(dtype)
    grid = torch.from_numpy(rng.uniform(-1.2, 1.2, size=(2, 6, 5, 2)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, 6, 5, 5)).astype(np.float32)).to(dtype)
    before = fw.grid_sample.launches, fw.grid_sample_bwd.launches
    assert torch.equal(fw.grid_sample(image, grid, mode), fw.grid_sample_plain(image, grid, mode))
    want = fw.grid_sample_plain_vjp(g, image, grid, mode)
    for image_grad in (False, True):
        for grid_grad in (False, True):
            d_image, d_grid = fw.grid_sample_bwd(g, image, grid, mode, image_grad=image_grad,
                                                 grid_grad=grid_grad)
            assert (d_image is None) != image_grad and (d_grid is None) != grid_grad
            if image_grad:
                assert torch.equal(d_image, want[0])
            if grid_grad:
                assert torch.equal(d_grid, want[1])
    assert (fw.grid_sample.launches, fw.grid_sample_bwd.launches) == before


# Normalised grid values on the clamp and fold lines (chip_smoke.py
# WARP_LINES): the border's bounds x = 0 and x = W - 1 (-1, 1; a reflection
# fold at W - 1), the reflection's period 2 (W - 1) and -2 (W - 1) (3, -5),
# and -(W - 1), which reflects onto the fold (-3).
LINES = (-1.0, 1.0, 3.0, -3.0, -5.0)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("mode", ["zeros", "border", "reflection"])
def test_line_derivatives_match_pallas_bwd(mode, axis):
    """d_grid at points on the clamp and fold lines (in x or in y), against
    ``jax.vjp`` of ``pallas_warp.grid_sample(..., interpret=True)``, the TPU
    kernel that kernel 8 replaces: ``grid_sample_dgrid_plain`` (the
    reference chip_smoke.py holds kernel 8's d_grid to) equals it within
    1e-5 of max(1, max|reference|), as tests/test_torch_warp_bwd.py holds
    the plain backward off the lines, and so does the plain backward's
    d_image. The plain backward's d_grid (autograd) equals it off the lines
    and, in border and reflection modes, differs on them."""
    rng = np.random.default_rng(11 + axis)
    H, W, C, Ho, Wo = 8, 16, 3, 8, 16  # the Pallas kernel's index split needs a power-of-two W
    image = rng.normal(size=(2, H, W, C)).astype(np.float32)
    grid = rng.uniform(-0.9, 0.9, size=(2, Ho, Wo, 2)).astype(np.float32)
    flat = grid.reshape(-1, 2)
    on = np.arange(flat.shape[0]) % 3 == 0
    flat[on, axis] = np.resize(np.asarray(LINES, np.float32), int(on.sum()))
    g = rng.normal(size=(2, Ho, Wo, C)).astype(np.float32)
    fn = jax.jit(lambda im, gr, ct: jax.vjp(
        lambda a, b: pallas_warp.grid_sample(a, b, mode, interpret=True), im, gr)[1](ct))
    want_image, want_grid = (np.asarray(t) for t in fn(jnp.asarray(image), jnp.asarray(grid),
                                                       jnp.asarray(g)))
    t = [torch.from_numpy(a) for a in (g, image, grid)]
    got = fw.grid_sample_dgrid_plain(*t, mode).numpy()
    d_image, d_grid = (a.numpy() for a in fw.grid_sample_plain_vjp(*t, mode))
    tol = 1e-5 * max(1.0, float(np.abs(want_grid).max()))
    assert np.abs(got - want_grid).max() <= tol
    assert np.abs(d_image - want_image).max() <= 1e-5 * max(1.0, np.abs(want_image).max())
    autograd = np.abs(d_grid - want_grid).reshape(-1, 2).max(-1)
    assert (autograd[~on] <= tol).all()
    assert (autograd[on].max() > tol) == (mode != "zeros")


@pytest.mark.parametrize("mode", ["zeros", "border", "reflection"])
def test_plain_nan_point_reads_pixel_zero(mode):
    """A NaN x: NaN output and NaN d_image at pixel 0 of the rows it reads,
    d_grid's x part 0 and its y part NaN (what kernel 8 gives: the x corners
    are one pixel, or all zero in zeros mode)."""
    image = torch.randn(1, 4, 5, 2, generator=torch.Generator().manual_seed(0))
    grid = torch.tensor([[[[float("nan"), 0.0]]]])
    out = fw.grid_sample_plain(image, grid, mode)
    d_image, d_grid = fw.grid_sample_plain_vjp(torch.ones(1, 1, 1, 2), image, grid, mode)
    assert torch.isnan(out).all()
    assert torch.isnan(d_image[0, :, :, 0]).nonzero().tolist() == [[1, 0], [2, 0]]
    assert d_grid[0, 0, 0, 0].item() == 0.0 and math.isnan(d_grid[0, 0, 0, 1].item())
    rule = fw.grid_sample_dgrid_plain(torch.ones(1, 1, 1, 2), image, grid, mode)
    assert rule[0, 0, 0, 0].item() == 0.0 and math.isnan(rule[0, 0, 0, 1].item())
