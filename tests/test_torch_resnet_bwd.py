"""Kernel 7 (the resnet block's backward, ``csrc/resnet.cu``) on the CPU:
the plain backward against the JAX package's kernel, and the host-side plan
of the bf16 body.

``resnet_block_plain_vjp`` (the autograd of ``resnet_block_plain``, the
plain version the card's kernel is held to) against
``pallas_resnet._bwd_kernel_impl`` in interpret mode, float32, to 2e-4 of
each gradient's size (GroupNorm statistics over a whole sample, summed in
another order), with and without FiLM and the residual projection.
``resnet_bwd_plan`` at the KTH and multi1248 train-step shapes and ragged
ones: the recompute is kernel 3's plan without the residual projection's
tiles, the dW splits are kernel 11's, the GroupNorm chunks fill the card
and partition each sample, and the scratch's bytes come from the source's
``resnet_bwd_scratch_bytes`` query (stood in by a fixture that carves the
layout the source's comment lists); its refusals; and the gradients' one
float32 buffer.
"""
import math
import re
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extdm_tpu.ops import pallas_resnet
from extdm_tpu_torch import _build, convert
from extdm_tpu_torch.ops import fused_resnet as fr
from extdm_tpu_torch.ops.conv_engine import wgrad_splits

NAMES = ("w1", "b1", "g1s", "g1b", "film", "w2", "b2", "g2s", "g2b", "wres", "bres")
SMS = 132


@pytest.mark.parametrize("film", [True, False])
@pytest.mark.parametrize("res", [True, False])
def test_plain_vjp_matches_jax_bwd_kernel(film, res):
    B, T, H, W, cin = 2, 3, 4, 6, 16
    cout, groups = (24 if res else 16), 4
    rng = np.random.default_rng(5 + 2 * film + res)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    p = dict(w1=f(1, 3, 3, cin, cout) / np.float32(np.sqrt(9 * cin)), b1=0.1 * f(cout),
             g1s=1 + 0.1 * f(cout), g1b=0.1 * f(cout), film=0.3 * f(B, 2 * cout) if film else None,
             w2=f(1, 3, 3, cout, cout) / np.float32(np.sqrt(9 * cout)), b2=0.1 * f(cout),
             g2s=1 + 0.1 * f(cout), g2b=0.1 * f(cout),
             wres=f(cin, cout) / np.float32(np.sqrt(cin)) if res else None,
             bres=0.1 * f(cout) if res else None)
    x, g = f(B, T, H, W, cin), f(B, T, H, W, cout)
    jargs = [None if p[k] is None else jnp.asarray(p[k]) for k in NAMES]
    want = pallas_resnet._bwd_kernel_impl(jnp.asarray(x), jnp.asarray(g), *jargs, groups, 1e-5,
                                          True)

    t = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    targs = dict(w1=t(convert.conv_weight(p["w1"])), w2=t(convert.conv_weight(p["w2"])),
                 wres=None if not res else t(convert.conv_weight(p["wres"][None, None, None])),
                 **{k: t(p[k]) for k in ("b1", "g1s", "g1b", "film", "b2", "g2s", "g2b", "bres")})
    got = fr.resnet_block_plain_vjp(t(g), t(x), *[targs[k] for k in NAMES], groups=groups)
    # JAX layouts -> the port's: conv kernels (1,3,3,I,O) and the (I, O) projection
    to_port = {1: lambda a: convert.conv_weight(np.asarray(a).reshape(1, 3, 3, *a.shape[1:])),
               6: lambda a: convert.conv_weight(np.asarray(a).reshape(1, 3, 3, *a.shape[1:])),
               10: lambda a: convert.conv_weight(np.asarray(a)[None, None, None])}
    for i, (gg, ww) in enumerate(zip(got, want)):
        if gg is None:
            assert i in (5, 10, 11) and (i != 5 or not film) and (i < 10 or not res)
            continue
        ww = to_port.get(i, np.asarray)(ww)
        ww = np.asarray(ww).reshape(gg.shape)
        assert gg.dtype == torch.float32
        err = np.abs(gg.numpy() - ww).max()
        assert err <= 2e-4 * max(np.abs(ww).max(), 1e-30), (i, err, np.abs(ww).max())


# (B, T, H, W, Cin, Cout, FiLM): the KTH train step's blocks at batch 8 (levels
# 32^2 to 4^2, the up blocks' concatenated inputs, the final convs without
# FiLM), multi1248's (512 output channels, up level 0's 1024 input channels)
# and ragged ones (channels off 16-byte rows, frames off the tiles, 4 groups)
KTH = [(8, 30, 32, 32, 64, 64, True), (8, 30, 32, 32, 128, 64, True),
       (8, 30, 32, 32, 128, 64, False), (8, 30, 16, 16, 64, 128, True),
       (8, 30, 8, 8, 256, 256, True), (8, 30, 4, 4, 512, 256, True)]
MULTI1248 = [(8, 30, 4, 4, 256, 512, True), (8, 30, 4, 4, 512, 512, True),
             (8, 30, 4, 4, 1024, 256, True), (8, 30, 8, 8, 768, 256, True)]
RAGGED = [(2, 3, 6, 6, 40, 96, True), (1, 4, 5, 7, 64, 64, False), (2, 3, 6, 6, 20, 20, True)]


def _source_layout(B, P, Kin, N, C, groups, res, film, s1, s2, sr, chunks):
    """The scratch as resnet.cu's BwdScratch carves it (its comment's list),
    each region rounded up to 256 bytes."""
    regions = [9 * Kin * N * 2, 9 * N * N * 2, Kin * N * 2 if res else 0,
               (7 * N + (2 * B * C if film else 0)) * 4, P * N * 4, P * N * 2, P * N * 4,
               P * N * 2, P * Kin * 4, P * Kin * 4 if res else 0, 4 * B * groups * 8, B * N * 8,
               2 * B * N * 16, B * N * 16, B * N * 32, B * chunks * N * 16,
               4 * max(s1 * 9 * Kin * N, s2 * 9 * N * N, sr * Kin * N if res else 0)]
    return sum(-(-r // 256) * 256 for r in regions)


@pytest.fixture
def queries(monkeypatch):
    """Stands in for the source's resnet_bwd_scratch_bytes query (the
    layout above); records each call."""
    asked = SimpleNamespace(calls=[])

    def query(source, name, *args):
        assert (source, name) == ("resnet", "resnet_bwd_scratch_bytes")
        asked.calls.append(args)
        return _source_layout(*args)

    monkeypatch.setattr(_build, "query", query)
    fr.resnet_bwd_plan.cache_clear()
    yield asked
    fr.resnet_bwd_plan.cache_clear()


def test_source_layout_lists_the_regions():
    """The fixture's layout is the source's: BwdScratch takes these regions."""
    text = (_build.CSRC / "resnet.cu").read_text()
    body = text[text.index("struct BwdScratch"):text.index("int block_bwd_wgmma")]
    takes = re.findall(r"(\w+) = take\(", body)
    assert takes == ["w1", "w2", "wr", "vec", "y1", "a1", "y2", "dy", "dx1", "dres", "stats",
                     "coef", "cf", "bc", "sums", "part", "wpart"]


@pytest.mark.parametrize("B,T,H,W,cin,cout,film", KTH + MULTI1248 + RAGGED)
def test_resnet_bwd_plan_covers_the_block(queries, B, T, H, W, cin, cout, film):
    pixels, groups = B * T * H * W, (4 if cout == 20 else 8)
    residual = cin != cout
    plan = fr.resnet_bwd_plan(B, pixels, cin, cout, groups, residual, film, SMS)
    rec = plan.recompute
    assert rec == fr.resnet_plan(pixels, cin, cout, False, SMS)  # kernel 3's, no residual tiles
    assert rec.conv1_grid == rec.conv2_grid
    # dW splits and launch blocks as kernel 11 plans them (conv33_plan)
    for splits, blocks, (k, n, taps) in ((plan.splits2, plan.grad_blocks[0], (rec.cout, rec.cout, 9)),
                                         (plan.splits1, plan.grad_blocks[1], (rec.cin, rec.cout, 9))):
        ti, to = -(-k // 128), -(-n // 128)
        assert splits == wgrad_splits(pixels, taps * ti * to, SMS)[0]
        if taps == 9 and k == rec.cin:
            assert splits == fr.conv33_plan(pixels, cin, cout, SMS).splits
        assert blocks == -(-pixels // 128) * ti + taps * splits * ti * to
    if residual:
        ti, to = -(-rec.cin // 128), -(-rec.cout // 128)
        assert plan.splits_r == wgrad_splits(pixels, ti * to, SMS)[0]
        assert plan.grad_blocks[2] == -(-pixels // 128) * ti + plan.splits_r * ti * to
    else:
        assert (plan.splits_r, plan.grad_blocks[2]) == (1, 0)
    # GroupNorm sums: chunks partition each sample, the blocks about fill the card
    S = pixels // B
    per = -(-S // plan.chunks)
    assert (plan.chunks - 1) * per < S <= plan.chunks * per  # no empty chunk
    cols = -(-rec.cout // fr.GN_PART_COLS)
    assert plan.gn_grid == (B * plan.chunks, cols)
    assert plan.chunks == 1 or per >= fr.GN_MIN_ROWS // 2
    assert B * plan.chunks * cols >= min(fr.GN_BLOCKS_PER_SM * SMS, B * -(-S // fr.GN_MIN_ROWS) * cols)
    # the scratch: asked of the source with the plan's own numbers
    assert queries.calls == [(B, pixels, rec.cin, rec.cout, cout, groups, int(residual), int(film),
                              plan.splits1, plan.splits2, plan.splits_r, plan.chunks)]
    assert plan.scratch == _source_layout(*queries.calls[0])
    assert fr.resnet_bwd_plan(B, pixels, cin, cout, groups, residual, film, SMS) is plan  # cached


@pytest.mark.parametrize("groups,cout,pixels,batch", [(64, 64, 8 * 30 * 16, 8), (8, 60, 8 * 30 * 16, 8),
                                                      (8, 64, 8 * 30 * 16 + 1, 8)])
def test_resnet_bwd_plan_refusals(queries, groups, cout, pixels, batch):
    with pytest.raises(ValueError, match="kernel 7 takes"):
        fr.resnet_bwd_plan(batch, pixels, 64, cout, groups, False, True, SMS)
    assert queries.calls == []


@pytest.mark.parametrize("residual,film", [(True, True), (False, False)])
def test_grad_buffer_layout(residual, film):
    """The gradients' one float32 buffer: dw1, dw2, (dwres), the six vectors,
    (dbres), (dfilm), in the order the source's entry documents."""
    B, cin, cout = 2, 40, 96
    shapes = fr.resnet_bwd_grad_shapes(B, cin, cout, residual, film)
    names = [n for n, _ in shapes]
    want = ["w1", "w2"] + (["wres"] if residual else []) + ["b1", "g1s", "g1b", "b2", "g2s", "g2b"]
    want += (["bres"] if residual else []) + (["film"] if film else [])
    assert names == want
    total = sum(math.prod(s) for _, s in shapes)
    assert total == (9 * cout * (cin + cout) + (cout * cin if residual else 0)
                     + (7 if residual else 6) * cout + (2 * B * cout if film else 0))
    text = (_build.CSRC / "resnet.cu").read_text()
    doc = text[text.index("// Kernel 7 in bf16 on the conv engine."):]
    assert "dw1 (Cout, Cin, 3, 3), dw2" in doc and "then dfilm (B, 2 Cout)" in doc


def test_kernel7_route_and_limits():
    """bf16 takes every width; float32 keeps its 256-channel body; groups."""
    assert fr._bwd_takes(512, 8, torch.bfloat16) and fr._bwd_takes(264, 8, torch.bfloat16)
    assert not fr._bwd_takes(264, 8, torch.float32) and fr._bwd_takes(256, 8, torch.float32)
    assert not fr._bwd_takes(64, 64, torch.bfloat16) and not fr._bwd_takes(60, 8, torch.bfloat16)
