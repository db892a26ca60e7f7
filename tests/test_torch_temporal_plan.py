"""Kernels 2 and 6's bf16 bodies (``csrc/stw_layer.cu`` ``temporal_layer_wgmma``,
``csrc/stw_layer_bwd.cu`` ``temporal_layer_bwd_wgmma``) on the CPU: the
host-side pieces the card's kernels depend on.

``temporal_plan`` and ``temporal_bwd_plan`` size the launches: they must cover
the layer and fit one block's shared memory, the layout's bytes coming from
the sources' ``temporal_smem`` / ``stw_bwd_smem`` queries (stood in for
here, since the libraries are built on the card only), and refuse what the
bodies do not take. ``stw_route`` sends every bf16 temporal layer of T <= 32
frames to kernels 2 and 6 up to 512 channels. The plain layer at 512
channels is held against JAX's ``temporal_layer_reference`` to 1e-5, the
plain backward at 320 channels against JAX's Pallas backward in interpret
mode (``_temporal_bwd_impl``) to 2e-4 of each gradient's size, both in
float32. The operands the entries write (``temporal_operands_plain``) and
the rope table the forward reads are held against their definitions.
"""
import re
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extdm_tpu.ops import pallas_stw
from extdm_tpu_torch import _build
from extdm_tpu_torch.nn.attention import apply_rotary
from extdm_tpu_torch.ops import fused_stw

SMEM_MAX = fused_stw.STW_SMEM_MAX


def test_frame_slots_are_the_kernels():
    """The route's T limit is the tiles' frame slots (``csrc/temporal.cuh`` SEQ)."""
    src = (_build.CSRC / "temporal.cuh").read_text()
    assert re.search(r"constexpr int SEQ = (\d+);", src).group(1) == str(fused_stw.TEMPORAL_SLOTS)


@pytest.fixture
def queries(monkeypatch):
    """Stands in for the sources' queries. temporal_smem: kernel 1's layout
    (``fused_stw._stw_smem``) plus the rows' ChanLN statistics (64 x 8
    bytes), the layout the temporal body adds them to; stw_bwd_smem:
    `base` + `per_stage` bytes a stage, set by the test. Records each call."""
    layout = SimpleNamespace(asked=[], base=0, per_stage=0)

    def query(source, name, *args):
        layout.asked.append((name, *args))
        if name == "temporal_scratch_bytes":
            assert source == "stw_layer"
            return 4096
        if name == "temporal_smem":
            assert source == "stw_layer"
            C, heads, cw, resident, stages, a_bufs = args
            nkp, hk = -(-C // 64), heads * 32 // 64
            rounds = -(-C // (2 * cw))
            qkv = heads // 4 * nkp * fused_stw.STW_QKV_STEP
            wbytes = (qkv + rounds * hk * min(2 * cw // 64, nkp) * fused_stw.STW_BOX if resident
                      else stages * fused_stw.STW_QKV_STEP)
            return fused_stw._stw_smem(nkp, hk, a_bufs, wbytes, 1 if resident else stages) + 512
        assert (source, name) == ("stw_layer_bwd", "stw_bwd_smem")
        return layout.base + layout.per_stage * args[2]

    monkeypatch.setattr(_build, "query", query)
    for fn in (fused_stw.temporal_plan, fused_stw.temporal_bwd_plan):
        fn.cache_clear()
    yield layout
    for fn in (fused_stw.temporal_plan, fused_stw.temporal_bwd_plan):
        fn.cache_clear()


@pytest.mark.parametrize("C", [32, 64, 96, 128, 192, 256, 320, 384, 512])
@pytest.mark.parametrize("heads", [4, 8])
def test_temporal_plan_covers_the_layer_and_fits(C, heads, queries):
    plan = fused_stw.temporal_plan(C, 30, heads, 32, 132)
    assert plan.smem <= SMEM_MAX and plan.scratch == 4096
    assert plan.cw in (64, 128) and plan.rounds * 2 * plan.cw >= C > (plan.rounds - 1) * 2 * plan.cw
    nkp = -(-C // 64)
    assert plan.steps == heads // 4 * nkp + plan.rounds * heads * 32 // 64
    if C <= 64 or heads == 8:  # the weights stay with every tile at C <= 64 (4 heads: 128)
        assert plan.resident == (C <= 64)
    assert plan.resident or plan.stages >= 2
    assert plan.blocks == 132
    # resident weights asked first, then the deepest ring; the first that fits stands
    smem = [a for a in queries.asked if a[0] == "temporal_smem"]
    assert smem[-1] == ("temporal_smem", C, heads, plan.cw, int(plan.resident), plan.stages,
                        plan.a_bufs)
    assert smem[0][4] == 1 and all(a[4] == 0 for a in smem if a[4] != 1)
    assert fused_stw.temporal_plan(C, 30, heads, 32, 132) is plan  # cached


@pytest.mark.parametrize("C", [32, 64, 288, 512])
@pytest.mark.parametrize("heads", [4, 8])
def test_temporal_bwd_plan_takes_the_deepest_ring_that_fits(C, heads, queries):
    for fits in (4, 3, 2):
        queries.base, queries.per_stage = 8192 * C // 32, (SMEM_MAX - 8192 * C // 32) // fits
        queries.asked.clear()
        fused_stw.temporal_bwd_plan.cache_clear()
        plan = fused_stw.temporal_bwd_plan(C, 30, heads, 32, 132)
        assert plan.stages == fits and plan.smem <= SMEM_MAX
        assert queries.asked == [("stw_bwd_smem", C, heads, s) for s in range(4, fits - 1, -1)]
        assert plan.steps == -(-C // 64) * (heads // 4 + heads // 2)
        assert plan.blocks == 132 and plan.ln_blocks >= 132
    queries.base, queries.per_stage = SMEM_MAX, 1
    fused_stw.temporal_bwd_plan.cache_clear()
    with pytest.raises(ValueError, match="fits"):
        fused_stw.temporal_bwd_plan(C, 30, heads, 32, 132)


@pytest.mark.parametrize("args", [(544, 30, 8, 32), (512, 33, 8, 32), (512, 30, 2, 32),
                                  (512, 30, 8, 16), (496, 30, 8, 32), (16, 30, 8, 32)])
@pytest.mark.parametrize("plan", ["temporal_plan", "temporal_bwd_plan"])
def test_temporal_plans_refuse_what_the_bodies_do_not_take(args, plan):
    with pytest.raises(ValueError):
        getattr(fused_stw, plan)(*args, 132)


@pytest.mark.parametrize("C,T,dim_head,dtype,route", [
    (288, 30, 32, torch.bfloat16, "fused"),
    (320, 30, 32, torch.bfloat16, "fused"),
    (512, 30, 32, torch.bfloat16, "fused"),     # multi1248's temporal layer: kernels 2 and 6
    (512, 32, 32, torch.bfloat16, "fused"),     # the tile's 32 frame slots
    (512, 33, 32, torch.bfloat16, "unfused"),
    (256, 33, 32, torch.bfloat16, "fused"),     # the narrow bodies take T <= 64 at 256
    (288, 30, 32, torch.float32, "unfused"),    # float32 keeps 256
    (256, 30, 32, torch.float32, "fused"),
    (512, 30, 64, torch.bfloat16, "unfused"),   # dim_head 64
    (288, 30, 64, torch.bfloat16, "unfused"),
])
def test_temporal_route_table(C, T, dim_head, dtype, route):
    assert fused_stw.stw_route(C, T, dim_head, dtype, temporal=True) == route


def _layer_inputs(seed, B, T, H, W, C, heads, dh):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    hid = heads * dh
    return dict(x=f(B, T, H, W, C), gamma=1 + 0.1 * f(C), ln_scale=1 + 0.1 * f(C),
                ln_bias=0.05 * f(C), w_qkv=f(C, 3 * hid) * C ** -0.5,
                w_proj=f(hid, C) * hid ** -0.5, bias=0.1 * f(heads, T, T), g=f(B, T, H, W, C))


def _torch_args(p):
    t = torch.from_numpy
    return (t(p["x"]), t(p["gamma"]), t(p["ln_scale"]), t(p["ln_bias"]), t(p["w_qkv"].T.copy()),
            t(p["w_proj"].T.copy()), t(p["bias"]))


def test_plain_layer_at_512_channels_matches_jax_reference():
    """Two pixels' sequences of 6 frames at 512 channels, 8 heads of 32."""
    p = _layer_inputs(31, 1, 6, 1, 2, 512, 8, 32)
    want = pallas_stw.temporal_layer_reference(
        *map(jnp.asarray, (p["x"], p["gamma"], p["ln_scale"], p["ln_bias"], p["w_qkv"],
                           p["w_proj"], p["bias"])), heads=8, dim_head=32, rotary=True)
    got = fused_stw.fused_temporal_layer(*_torch_args(p), heads=8, dim_head=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_plain_backward_at_320_channels_matches_jax_interpret():
    """Three pixels' sequences of 5 frames at 320 channels, 4 heads of 32:
    the gradients of ``temporal_layer_bwd``'s CPU path (autograd of the plain
    layer) against the Pallas backward kernel run in interpret mode."""
    heads, dh = 4, 32
    p = _layer_inputs(32, 1, 5, 1, 3, 320, heads, dh)
    want = pallas_stw._temporal_bwd_impl(
        *map(jnp.asarray, (p["x"], p["gamma"], p["ln_scale"], p["ln_bias"], p["w_qkv"],
                           p["w_proj"], p["bias"], p["g"])),
        heads=heads, dim_head=dh, rotary=True, eps=1e-5, interpret=True)
    got = fused_stw.temporal_layer_bwd(torch.from_numpy(p["g"]), *_torch_args(p), heads=heads,
                                       dim_head=dh)
    got = [got[0], got[1], got[2], got[3], got[4].T, got[5].T, got[6]]
    names = ("dx", "dgamma", "dln_scale", "dln_bias", "dwqkv", "dwout", "dbias")
    for name, a, b in zip(names, got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=2e-4 * np.abs(b).max(),
                                   err_msg=name)


@pytest.mark.parametrize("T", [7, 30, 32])
def test_operands_are_their_definitions(T):
    """What the entries write before the layer: bf16 weights, the three
    vectors in float32 and the bias table (heads, 32, 32), bf16(bias) inside
    T x T and -inf past T in rows and columns, and its transpose."""
    heads, C = 4, 96
    g = torch.Generator().manual_seed(T)
    w_qkv = torch.randn(3 * heads * 32, C, generator=g)
    w_out = torch.randn(C, heads * 32, generator=g)
    vecs = [torch.randn(C, generator=g) for _ in range(3)]
    bias = torch.randn(heads, T, T, generator=g)
    ops = fused_stw.temporal_operands(w_qkv, w_out, *vecs, bias)  # the CPU: the plain version
    assert torch.equal(ops["wq"], w_qkv.bfloat16()) and torch.equal(ops["wo"], w_out.bfloat16())
    assert torch.equal(ops["vec"], torch.cat(vecs))
    bm = ops["bm"]
    assert bm.shape == (heads, 32, 32) and bm.dtype == torch.bfloat16 and bm.is_contiguous()
    assert torch.equal(bm[:, :T, :T], bias.bfloat16())
    assert torch.isneginf(bm[:, T:, :].float()).all() and torch.isneginf(bm[:, :, T:].float()).all()
    assert torch.equal(ops["bmt"], bm.transpose(-1, -2)) and ops["bmt"].is_contiguous()


@pytest.mark.parametrize("T", [7, 30])
def test_rope_pairs_rotate_as_apply_rotary(T):
    """The forward's rope table (T, rot / 2, 4): cos and sin of each dim pair,
    applied per pair at the frame's position as the kernel does, is the
    plain version's rotary embedding."""
    q = torch.randn(3, T, 32, generator=torch.Generator().manual_seed(1))
    cs = fused_stw._rope_pairs(T, 32, torch.device("cpu"))
    q0, q1 = q[..., 0::2], q[..., 1::2]
    rot = torch.stack([q0 * cs[..., 0] - q1 * cs[..., 1], q1 * cs[..., 2] + q0 * cs[..., 3]], -1)
    torch.testing.assert_close(rot.reshape(q.shape), apply_rotary(q, 32), rtol=1e-6, atol=1e-6)
