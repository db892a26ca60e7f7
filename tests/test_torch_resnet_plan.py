"""Kernel 3's bf16 body (``csrc/resnet.cu`` resnet_block_wgmma, on
``csrc/conv_ring.cuh``'s engine) on the CPU: the host-side pieces the card's
kernel depends on.

``tap_major`` converts the conv weights to the (taps, Cin, Cout) bf16
layout TMA reads, zero past the real channels: its plain version is held
against ``taps`` exactly. ``resnet_plan`` sizes the launches: the 128-row
pixel tiles run across frames and samples (pixels = B T H W), the column
tiles cover Cout (doubled with the residual projection), channels are
padded to the engine's 16-byte rows only where they need it, and a conv of
few reduction steps takes the 3-stage ring that lets two blocks share an SM.
"""
import re

import pytest
import torch

from extdm_tpu_torch import _build
from extdm_tpu_torch.ops import fused_resnet as fr

SMEM_PER_SM = 232448
SMS = 132


@pytest.mark.parametrize("cout,cin,taps_hw,cin_p,cout_p", [
    (64, 64, (3, 3), 64, 64),
    (96, 40, (3, 3), 40, 96),
    (20, 20, (3, 3), 24, 24),    # 4 groups of 5 channels: padded to 16-byte rows
    (512, 1024, (1, 1), 1024, 512),  # the residual projection, one tap
])
def test_tap_major_weights(cout, cin, taps_hw, cin_p, cout_p):
    w = torch.randn(cout, cin, 1, *taps_hw)
    got = fr.tap_major(w, cin_p, cout_p)
    ntaps = taps_hw[0] * taps_hw[1]
    assert got.dtype == torch.bfloat16 and got.shape == (ntaps, cin_p, cout_p)
    want = w[:, :, 0].permute(2, 3, 1, 0).reshape(ntaps, cin, cout).bfloat16()
    if ntaps == 9:
        assert torch.equal(want, fr.taps(w).bfloat16())  # the taps of kernels 10 and 11
    assert torch.equal(got[:, :cin, :cout], want)
    assert not got[:, cin:].any() and not got[:, :, cout:].any()


# (B, T, H, W, Cin, Cout): the KTH sampler's blocks at batch 4 (levels 32^2 to
# 4^2, the up blocks' concatenated inputs) and multi1248's over 256 channels
KTH = [(4, 30, 32, 32, 64, 64), (4, 30, 32, 32, 128, 64), (4, 30, 16, 16, 64, 128),
       (4, 30, 16, 16, 128, 128), (4, 30, 16, 16, 256, 128), (4, 30, 8, 8, 128, 256),
       (4, 30, 8, 8, 256, 256), (4, 30, 8, 8, 512, 256), (4, 30, 4, 4, 256, 256),
       (4, 30, 4, 4, 512, 256)]
MULTI1248 = [(4, 30, 4, 4, 256, 512), (4, 30, 4, 4, 512, 512), (4, 30, 4, 4, 1024, 512),
             (4, 30, 8, 8, 768, 256)]
RAGGED = [(2, 3, 6, 6, 40, 96), (1, 4, 5, 7, 64, 64), (2, 5, 5, 7, 96, 160), (2, 3, 6, 6, 20, 20)]


def _source_ring_smem(stages, bn):
    text = (_build.CSRC / "conv_ring.cuh").read_text()
    assert ("constexpr int ring_smem() { return S * TILE + S * BN * GK * 2 + 8 * S + 1024; }"
            in text)
    gk = int(re.search(r"constexpr int GK = (\d+);", text).group(1))
    tile = int(re.search(r"constexpr int GM = (\d+);", text).group(1)) * gk * 2
    return stages * tile + stages * bn * gk * 2 + 8 * stages + 1024


@pytest.mark.parametrize("B,T,H,W,cin,cout", KTH + MULTI1248 + RAGGED)
def test_resnet_plan_covers_the_block(B, T, H, W, cin, cout):
    pixels = B * T * H * W
    residual = cin != cout
    plan = fr.resnet_plan(pixels, cin, cout, residual, SMS)
    for have, padded in ((cin, plan.cin), (cout, plan.cout)):
        assert padded % fr.CONV_CHANNEL_ALIGN == 0 and have <= padded < have + 8
        assert (padded == have) == (have % 8 == 0)
    rows, cols = plan.conv2_grid
    # 64-column tiles where Cout is no wider, or where 128-wide ones would
    # leave half the SMs without a block
    narrow = plan.cout <= fr.NARROW_TILE or 2 * rows * -(-plan.cout // fr.CONV_TILE) < SMS
    assert plan.bn == (fr.NARROW_TILE if narrow else fr.CONV_TILE)
    # pixel tiles run across frames and samples: no tile per frame
    assert (rows - 1) * fr.CONV_TILE < pixels <= rows * fr.CONV_TILE
    assert (cols - 1) * plan.bn < plan.cout <= cols * plan.bn
    assert plan.conv1_grid == (rows, cols * (2 if residual else 1))
    for k, stages, smem in ((plan.cin, plan.stages1, plan.smem1),
                            (plan.cout, plan.stages2, plan.smem2)):
        few = 9 * -(-k // fr.CONV_STEP) <= fr.FEW_STEPS
        assert stages == (fr.FEW_STEP_STAGES if few else fr.CONV_STAGES)
        assert smem == fr.ring_smem(stages, plan.bn) == _source_ring_smem(stages, plan.bn)
        # two 3-stage blocks (three narrow ones) and their 2 KB of statistics share one SM
        blocks = (3 if narrow else 2) if few else 1
        assert blocks * (smem + 2048) <= SMEM_PER_SM
    assert fr.resnet_plan(pixels, cin, cout, residual, SMS) is plan  # cached


def test_resnet_plan_rings_and_tile_widths():
    """KTH's 64-channel level: 64-column tiles on the 3-stage ring (three
    blocks an SM); its 128-channel level: 9 or 18 reduction steps, the
    3-stage ring (two), 128-column tiles (240 x 1 blocks); the 4 x 4
    blocks at batch 4, multi1248's 512-channel ones among them: 36 steps or
    more, the 5-stage ring, 64-column tiles (15 rows of pixel tiles)."""
    assert fr.resnet_plan(4 * 30 * 32 * 32, 64, 64, False, SMS)[4:7] == (3, 3, 64)
    assert fr.resnet_plan(4 * 30 * 32 * 32, 128, 64, True, SMS)[4:7] == (3, 3, 64)
    assert fr.resnet_plan(4 * 30 * 16 * 16, 128, 128, False, SMS)[4:7] == (3, 3, 128)
    assert fr.resnet_plan(4 * 30 * 4 * 4, 256, 256, False, SMS)[4:7] == (5, 5, 64)
    assert fr.resnet_plan(4 * 30 * 4 * 4, 512, 512, False, SMS)[4:7] == (5, 5, 64)
    assert fr.resnet_plan(4 * 30 * 4 * 4, 1024, 512, True, SMS)[4:7] == (5, 5, 64)
    # 8 x 8 at batch 4 and 4 x 4 at batch 8: 120 blocks of 128 columns
    assert fr.resnet_plan(4 * 30 * 8 * 8, 256, 256, False, SMS)[4:7] == (5, 5, 128)
    assert fr.resnet_plan(8 * 30 * 4 * 4, 512, 512, False, SMS)[4:7] == (5, 5, 128)


def test_size_queries_match_their_declarations():
    """Each layout's bytes are asked of the source that carves it: every
    ``_build.query(source, name, *args)`` call passes as many arguments as
    the ``extern "C" long long`` query it names declares, and every query
    is called. Kernel 3's scratch passes 2 GiB at KTH's 64-channel level
    when an evaluation's trajectories ride the batch, so its size goes to
    the entry, and the pixels to the query, as 64-bit integers; kernel 7's
    the same way."""
    import ast
    import ctypes

    calls = {}
    for path in sorted((_build.CSRC.parent / "ops").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "query"
                    and getattr(node.func.value, "id", "") == "_build"):
                source, name = (a.value for a in node.args[:2])
                calls[(source, name)] = len(node.args) - 2
    queries = {(src.stem, name): len(types) for src in _build.CSRC.glob("*.cu")
               for name, types in _build.size_queries(src.stem).items()}
    assert calls == queries == {("resnet", "resnet_scratch_bytes"): 8,
                                ("resnet", "resnet_bwd_scratch_bytes"): 12,
                                ("stw_layer_bwd", "stw_bwd_smem"): 3,
                                ("stw_layer", "temporal_smem"): 6,
                                ("stw_layer", "temporal_scratch_bytes"): 2,
                                ("stw_layer_bwd", "temporal_bwd_scratch_bytes"): 8,
                                ("grid_sample", "grid_sample_smem"): 2}
    for query in ("resnet_scratch_bytes", "resnet_bwd_scratch_bytes"):
        assert _build.size_queries("resnet")[query][1] is ctypes.c_longlong
    for entry in ("resnet_block_wgmma", "resnet_block_bwd_wgmma"):
        params = re.search(rf'extern "C" int {entry}\(([^)]*)\)',
                           (_build.CSRC / "resnet.cu").read_text()).group(1).split(",")
        at = [i for i, p in enumerate(params) if p.split()[-1] == "scratch_bytes"]
        assert len(at) == 1
        assert _build.entry_points("resnet")[entry][at[0]] is ctypes.c_longlong
