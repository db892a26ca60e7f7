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
from extdm_tpu_torch.ops import fused_resnet


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


@pytest.mark.parametrize("cin,cout,groups,route", [
    (128, 256, 8, "fused"),
    (256, 512, 8, "decomposed"),      # Cout > 256: kernel 7's per-channel sums
    (512, 512, 8, "decomposed"),
    (1024, 256, 8, "fused"),          # up level 0 of multi1248: wide input only
    (256, 264, 8, "decomposed"),      # just over the limit
    (64, 64, 64, "decomposed"),       # more groups than kernel 7 holds
    (64, 64, 32, "fused"),
    (64, 60, 8, "decomposed"),        # groups that do not divide Cout
    (64, 64, 8, "fused"),
])
def test_resnet_bwd_route_table(cin, cout, groups, route):
    assert fused_resnet.resnet_bwd_route((8, 30, 4, 4, cin), cin, cout, groups) == route
