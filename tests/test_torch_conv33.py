"""Kernels 10 and 11 (the (1,3,3) conv and its gradients) and the decomposed
resnet backward of extdm_tpu_torch.ops.fused_resnet against the JAX
package, on the CPU, float32.

On the CPU the wrappers run their plain versions. ``conv33_plain`` and
``conv33_bwd_plain`` are held against ``pallas_resnet._conv33_fwd`` and
``_conv33_bwd`` in interpret mode to 1e-5 of the output's size (float32
sums in another order); ``resnet_block_bwd_decomposed`` against
``pallas_resnet._chunked_bwd`` in interpret mode and against the port's plain
VJP (autograd of ``resnet_block_plain``) to 1e-4 of each gradient's size
(GroupNorm statistics over a whole sample, summed in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extdm_tpu.ops import pallas_resnet
from extdm_tpu_torch import convert
from extdm_tpu_torch.ops import conv_engine, fused_resnet


def rel_close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (err, np.abs(want).max())


@pytest.mark.parametrize("shape,cout", [
    ((2, 3, 5, 7, 12), 20),    # ragged frame, channels off the tiles
    ((1, 2, 4, 4, 40), 72),    # the 4 x 4 frames of the deepest level
    ((1, 1, 1, 9, 8), 8),      # one row
])
def test_conv33_plain_matches_jax_interpret(shape, cout):
    rng = np.random.default_rng(0)
    cin = shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(9, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    b = rng.normal(size=cout).astype(np.float32)
    da = rng.normal(size=shape[:-1] + (cout,)).astype(np.float32)
    want = pallas_resnet._conv33_fwd(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                     interpret=True)
    want_din, want_dw = pallas_resnet._conv33_bwd(jnp.asarray(da), jnp.asarray(x),
                                                  jnp.asarray(w), interpret=True)
    t = torch.from_numpy
    got = fused_resnet.conv33_plain(t(x), t(w), t(b))
    got_din, got_dw = fused_resnet.conv33_bwd_plain(t(da), t(x), t(w))
    assert got.dtype == got_din.dtype == got_dw.dtype == torch.float32
    rel_close(got, want, 1e-5)
    rel_close(got_din, want_din, 1e-5)
    rel_close(got_dw, want_dw, 1e-5)


def test_conv33_wrappers_take_plain_path_on_cpu_and_refuse_other_devices():
    rng = np.random.default_rng(1)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    x, w, b, da = t(1, 2, 4, 4, 8), t(9, 8, 16), t(16), t(1, 2, 4, 4, 16)
    before = (fused_resnet.conv33_fwd.launches, fused_resnet.conv33_bwd.launches)
    assert torch.equal(fused_resnet.conv33_fwd(x, w, b), fused_resnet.conv33_plain(x, w, b))
    for got, want in zip(fused_resnet.conv33_bwd(da, x, w),
                         fused_resnet.conv33_bwd_plain(da, x, w)):
        assert torch.equal(got, want)
    assert (fused_resnet.conv33_fwd.launches, fused_resnet.conv33_bwd.launches) == before
    meta = lambda *a: [v.to("meta") for v in a]  # noqa: E731
    with pytest.raises(ValueError):
        fused_resnet.conv33_fwd(*meta(x, w, b))
    with pytest.raises(ValueError):
        fused_resnet.conv33_bwd(*meta(da, x, w))


def test_conv33_taps_match_torch_conv_layout():
    """``taps`` of a Conv3d weight gives the (ky, kx)-ordered (9, Cin, Cout)
    taps whose conv is the Conv3d's, and the JAX flax kernel's reshape."""
    rng = np.random.default_rng(2)
    flax_kernel = rng.normal(size=(1, 3, 3, 6, 10)).astype(np.float32)
    w = torch.from_numpy(convert.conv_weight(flax_kernel).copy())
    np.testing.assert_array_equal(fused_resnet.taps(w).numpy(), flax_kernel.reshape(9, 6, 10))
    x = torch.from_numpy(rng.normal(size=(2, 3, 5, 5, 6)).astype(np.float32))
    want = torch.nn.functional.conv3d(x.permute(0, 4, 1, 2, 3), w, padding=(0, 1, 1))
    rel_close(fused_resnet.conv33_plain(x, fused_resnet.taps(w), None),
              want.permute(0, 2, 3, 4, 1), 1e-6)


NAMES = ("w1", "b1", "g1s", "g1b", "film", "w2", "b2", "g2s", "g2b", "wres", "bres")


@pytest.mark.parametrize("film", [True, False])
@pytest.mark.parametrize("res", [True, False])
def test_decomposed_bwd_matches_jax_chunked_and_plain_vjp(film, res):
    B, T, H, W, cin = 2, 3, 4, 6, 16
    cout, groups = (24 if res else 16), 4
    rng = np.random.default_rng(3 + 2 * film + res)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    p = dict(w1=f(1, 3, 3, cin, cout) / np.float32(np.sqrt(9 * cin)), b1=0.1 * f(cout),
             g1s=1 + 0.1 * f(cout), g1b=0.1 * f(cout), film=0.3 * f(B, 2 * cout) if film else None,
             w2=f(1, 3, 3, cout, cout) / np.float32(np.sqrt(9 * cout)), b2=0.1 * f(cout),
             g2s=1 + 0.1 * f(cout), g2b=0.1 * f(cout),
             wres=f(cin, cout) / np.float32(np.sqrt(cin)) if res else None,
             bres=0.1 * f(cout) if res else None)
    x, g = f(B, T, H, W, cin), f(B, T, H, W, cout)
    jargs = [None if p[k] is None else jnp.asarray(p[k]) for k in NAMES]
    want = pallas_resnet._chunked_bwd(jnp.asarray(x), jnp.asarray(g), *jargs, 4, 1e-5, True)

    t = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    targs = dict(w1=t(convert.conv_weight(p["w1"])), w2=t(convert.conv_weight(p["w2"])),
                 wres=None if not res else t(convert.conv_weight(p["wres"][None, None, None])),
                 **{k: t(p[k]) for k in ("b1", "g1s", "g1b", "film", "b2", "g2s", "g2b", "bres")})
    args = [t(x)] + [targs[k] for k in NAMES]
    got = fused_resnet.resnet_block_bwd_decomposed(t(g), *args, groups=groups)
    plain = fused_resnet.resnet_block_plain_vjp(t(g), *args, groups=groups)
    # JAX layouts -> the port's: conv kernels (1,3,3,I,O) and the (I, O) projection
    to_port = {1: lambda a: convert.conv_weight(np.asarray(a)),
               6: lambda a: convert.conv_weight(np.asarray(a)),
               10: lambda a: convert.conv_weight(np.asarray(a)[None, None, None])}
    for i, (gg, pp, ww) in enumerate(zip(got, plain, want)):
        if ww is None:
            assert gg is None and pp is None
            continue
        ww = to_port.get(i, np.asarray)(ww)
        assert gg.dtype == torch.float32
        rel_close(gg.numpy(), ww.reshape(gg.shape), 1e-4)
        rel_close(gg.numpy(), pp.numpy(), 1e-4)


@pytest.mark.parametrize("cin,cout,groups,dtype,route", [
    (128, 256, 8, torch.bfloat16, "fused"),
    (256, 512, 8, torch.bfloat16, "fused"),       # kernel 7's bf16 body takes any width
    (512, 512, 8, torch.bfloat16, "fused"),
    (1024, 256, 8, torch.bfloat16, "fused"),      # up level 0 of multi1248
    (256, 264, 8, torch.bfloat16, "fused"),
    (256, 512, 8, torch.float32, "decomposed"),   # float32: per-channel sums in shared memory
    (256, 264, 8, torch.float32, "decomposed"),   #   (Cout <= 256), just over the limit
    (1024, 256, 8, torch.float32, "fused"),
    (64, 64, 64, torch.bfloat16, "decomposed"),   # more groups than kernel 7 holds
    (64, 64, 32, torch.bfloat16, "fused"),
    (64, 60, 8, torch.bfloat16, "decomposed"),    # groups that do not divide Cout
    (64, 64, 8, torch.bfloat16, "fused"),
])
def test_resnet_bwd_route_table(cin, cout, groups, dtype, route):
    assert fused_resnet.resnet_bwd_route((8, 30, 4, 4, cin), cin, cout, groups, dtype) == route


# ------------------------------------------------- the bf16 kernels' plan and operands
SMS = 132  # an H100 SXM's SMs
PLAN_SHAPES = [
    (8 * 30 * 4 * 4, 512, 512),     # multi1248's deepest level and mid blocks
    (8 * 30 * 4 * 4, 256, 512),     #   their first conv
    (8 * 30 * 32 * 32, 64, 64),     # the KTH step's resnet blocks, 32^2 ... 4^2
    (8 * 30 * 16 * 16, 64, 128),
    (8 * 30 * 16 * 16, 128, 128),
    (8 * 30 * 8 * 8, 128, 256),
    (8 * 30 * 8 * 8, 256, 256),
    (8 * 30 * 4 * 4, 256, 256),
    (8 * 30 * 4 * 4, 512, 256),
    (2 * 3 * 5 * 7, 12, 20),        # the test shapes: ragged channels and frames
    (1 * 2 * 4 * 4, 40, 72),
    (1 * 1 * 1 * 9, 8, 8),
    (3 * 7 * 6 * 5, 64, 96),        # pixels not a multiple of the row tile
]


def _source_constants():
    """GM, GN, GK and STAGES as csrc/conv_ring.cuh (the engine conv33.cu
    includes) declares them."""
    import re
    from extdm_tpu_torch import _build
    text = (_build.CSRC / "conv_ring.cuh").read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
            for name in ("GM", "GN", "GK", "STAGES")}


@pytest.mark.parametrize("pixels,cin,cout", PLAN_SHAPES)
def test_conv33_plan_covers_the_problem(pixels, cin, cout):
    """Tiles cover M and N, the dW splits partition the pixels in order,
    the ring fits a block's shared memory, channels are padded with zeros to
    16-byte rows only where they need it, and dW's blocks fill the card: the
    SM with the most steps has at most twice the steps of an even share (or
    a few steps, where the partials would cost more than they save)."""
    c = _source_constants()
    fr = fused_resnet
    assert (c["GM"], c["GN"], c["GK"], c["STAGES"]) == (fr.CONV_TILE, fr.CONV_TILE, fr.CONV_STEP,
                                                        fr.CONV_STAGES)
    plan = fr.conv33_plan(pixels, cin, cout, SMS)
    for have, padded in ((cin, plan.cin), (cout, plan.cout)):
        assert padded % fr.CONV_CHANNEL_ALIGN == 0 and have <= padded < have + 8
        assert (padded == have) == (have % 8 == 0)
    tile = fr.CONV_TILE
    for (rows, cols), n in ((plan.fwd_grid, plan.cout), (plan.din_grid, plan.cin)):
        assert (rows - 1) * tile < pixels <= rows * tile
        assert (cols - 1) * tile < n <= cols * tile
    ci, co, z = plan.wgrad_grid
    assert (ci - 1) * tile < plan.cin <= ci * tile and (co - 1) * tile < plan.cout <= co * tile
    assert z == 9 * plan.splits
    step = plan.per * fr.CONV_STEP
    ranges = [(s * step, min(pixels, (s + 1) * step)) for s in range(plan.splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == pixels
    assert all(a < b for a, b in ranges) and all(r[1] == n[0] for r, n in zip(ranges, ranges[1:]))
    assert plan.smem == (2 * c["STAGES"] * c["GM"] * c["GK"] * 2 + 8 * c["STAGES"] + 1024)
    assert plan.smem <= conv_engine.SMEM_PER_BLOCK
    steps = -(-pixels // fr.CONV_STEP)
    blocks = ci * co * z
    assert (-(-blocks // SMS) * plan.per <= 2 * -(-ci * co * 9 * steps // SMS)
            or plan.per <= 8)


def test_conv33_plan_splits_the_few_tile_cases():
    """KTH's 64-channel blocks (9 dW tiles over 245,760 pixels) split the
    pixels to fill the card; multi1248's 144 tiles of 512 x 512 need none."""
    kth = fused_resnet.conv33_plan(8 * 30 * 32 * 32, 64, 64, SMS)
    assert kth.splits >= 14 and kth.splits * 9 <= 2 * SMS
    assert fused_resnet.conv33_plan(8 * 30 * 4 * 4, 512, 512, SMS).splits == 1


def _taps_of(x):
    """(F, H, W, C) -> the 9 tap-shifted copies (ky, kx order), zeros off the frame."""
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    H, W = x.shape[1:3]
    return [xp[:, ky:ky + H, kx:kx + W] for ky in range(3) for kx in range(3)]


def test_conv33_prepared_operands_tap_sums_match_plain_and_jax():
    """The operands the bf16 kernels read (channels zero-padded 12 -> 16 and
    20 -> 24), summed tap by tap with einsum, give conv33_plain's and
    conv33_bwd_plain's results and JAX's interpret-mode _conv33_fwd /
    _conv33_bwd, to 1e-5 of each output's size."""
    shape, cout = (2, 3, 5, 7, 12), 20
    B, T, H, W, cin = shape
    rng = np.random.default_rng(4)
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(9, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    b = rng.normal(size=cout).astype(np.float32)
    da = rng.normal(size=shape[:-1] + (cout,)).astype(np.float32)
    t = torch.from_numpy
    plan = fused_resnet.conv33_plan(B * T * H * W, cin, cout, SMS)
    assert (plan.cin, plan.cout) == (16, 24)

    x2, wp, bp = fused_resnet.conv33_fwd_operands(t(x), t(w), t(b), plan)
    assert tuple(x2.shape) == (B * T * H * W, 16) and tuple(wp.shape) == (9, 16, 24)
    assert not x2[:, cin:].any() and not wp[:, cin:].any() and not wp[:, :, cout:].any()
    xs = _taps_of(x2.reshape(B * T, H, W, 16))
    out = sum(torch.einsum("fhwc,cn->fhwn", xs[k], wp[k]) for k in range(9)) + bp
    assert not out[..., cout:].any()
    out = out[..., :cout].reshape(B, T, H, W, cout)
    rel_close(out, fused_resnet.conv33_plain(t(x), t(w), t(b)), 1e-5)
    rel_close(out, pallas_resnet._conv33_fwd(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                             interpret=True), 1e-5)

    dap, ap, wq = fused_resnet.conv33_bwd_operands(t(da), t(x), t(w), plan)
    assert tuple(dap.shape) == (B * T * H * W, 24) and tuple(ap.shape) == (B * T * H * W, 16)
    d4, a4 = dap.reshape(B * T, H, W, 24), ap.reshape(B * T, H, W, 16)
    # din: da shifted back by each tap (the mirrored tap), times that tap's weights transposed
    ds = _taps_of(d4)
    din = sum(torch.einsum("fhwn,cn->fhwc", ds[8 - k], wq[k]) for k in range(9))
    dw = torch.stack([torch.einsum("fhwc,fhwn->cn", s, d4) for s in _taps_of(a4)])
    assert not din[..., cin:].any() and not dw[:, cin:].any() and not dw[:, :, cout:].any()
    din, dw = din[..., :cin].reshape(shape), dw[:, :cin, :cout]
    want_din, want_dw = fused_resnet.conv33_bwd_plain(t(da), t(x), t(w))
    rel_close(din, want_din, 1e-5)
    rel_close(dw, want_dw, 1e-5)
    jdin, jdw = pallas_resnet._conv33_bwd(jnp.asarray(da), jnp.asarray(x), jnp.asarray(w),
                                          interpret=True)
    rel_close(din, jdin, 1e-5)
    rel_close(dw, jdw, 1e-5)


def test_conv33_operands_are_not_copied_when_already_as_the_kernel_reads_them():
    """At channel counts that are multiples of 8 the prepared activations are
    the caller's own storage: no copy, no cast."""
    x = torch.randn(2, 3, 4, 4, 64).to(torch.bfloat16)
    w = torch.randn(9, 64, 32).to(torch.bfloat16)
    da = torch.randn(2, 3, 4, 4, 32).to(torch.bfloat16)
    plan = fused_resnet.conv33_plan(96, 64, 32, SMS)
    x2, wp, _ = fused_resnet.conv33_fwd_operands(x, w, None, plan)
    assert x2.data_ptr() == x.data_ptr() and wp.data_ptr() == w.data_ptr()
    dap, ap, wq = fused_resnet.conv33_bwd_operands(da, x, w, plan)
    assert (dap.data_ptr(), ap.data_ptr(), wq.data_ptr()) == (da.data_ptr(), x.data_ptr(),
                                                             w.data_ptr())
