"""Kernel 5's bf16 body (``csrc/stw_layer_bwd.cu``) on the CPU: the host-side
pieces the card's kernel depends on.

``stw_bwd_plan`` sizes the window kernel's launch: it takes the deepest
weight ring (two to four stages) whose layout fits one block's shared
memory, the layout's bytes coming from the source's ``stw_bwd_smem`` query
(replaced here by a stand-in, since the library is built on the card only),
and it refuses what the body does not take. ``stw_route`` sends every bf16
window layer kernels 1 and 5 take to them. The plain window-layer backward
(the wrapper's CPU path, kernel 5's plain version) is held against JAX's
``pallas_stw._stw_bwd_impl`` (the Pallas backward kernel in interpret mode)
at 288 channels, two windows, in float32, to 2e-4 of each gradient's size.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extdm_tpu.nn.attention import _relative_position_index
from extdm_tpu.ops import pallas_stw
from extdm_tpu_torch import _build
from extdm_tpu_torch.ops import fused_stw


@pytest.fixture
def smem_query(monkeypatch):
    """Stands in for the source's query: `base` + `per_stage` bytes a stage,
    set by the test; records each (C, heads, stages) asked."""
    layout = SimpleNamespace(asked=[], base=0, per_stage=0)

    def query(source, name, C, heads, stages):
        assert (source, name) == ("stw_layer_bwd", "stw_bwd_smem")
        layout.asked.append((C, heads, stages))
        return layout.base + layout.per_stage * stages

    monkeypatch.setattr(_build, "query", query)
    fused_stw.stw_bwd_plan.cache_clear()
    yield layout
    fused_stw.stw_bwd_plan.cache_clear()


@pytest.mark.parametrize("C", [32, 64, 96, 128, 192, 256, 288, 320, 384, 512])
@pytest.mark.parametrize("heads", [4, 8])
def test_stw_bwd_plan_takes_the_deepest_ring_that_fits(C, heads, smem_query):
    limit = fused_stw.STW_SMEM_MAX
    for fits in (4, 3, 2):  # the layout fits up to `fits` stages
        smem_query.base, smem_query.per_stage = 8192 * C // 32, (limit - 8192 * C // 32) // fits
        smem_query.asked.clear()
        fused_stw.stw_bwd_plan.cache_clear()
        plan = fused_stw.stw_bwd_plan(C, 64, heads, 32, 132)
        assert plan.stages == fits and plan.smem <= limit
        assert plan.smem == smem_query.base + smem_query.per_stage * fits
        # asked deepest first, down to the first that fits
        assert smem_query.asked == [(C, heads, s) for s in range(4, fits - 1, -1)]
        # dO's K-blocks per 128-column half, then each pair's
        assert plan.steps == -(-C // 64) * (heads // 4 + heads // 2)
        assert plan.blocks == 132 and plan.ln_blocks >= 132
    smem_query.base, smem_query.per_stage = limit, 1  # not even two stages fit
    fused_stw.stw_bwd_plan.cache_clear()
    with pytest.raises(ValueError, match="fits"):
        fused_stw.stw_bwd_plan(C, 64, heads, 32, 132)


@pytest.mark.parametrize("args", [(544, 64, 8, 32), (512, 65, 8, 32), (512, 64, 2, 32),
                                  (512, 64, 8, 16), (496, 64, 8, 32), (16, 64, 8, 32)])
def test_stw_bwd_plan_refuses_what_the_body_does_not_take(args):
    with pytest.raises(ValueError):
        fused_stw.stw_bwd_plan(*args, 132)


@pytest.mark.parametrize("C,kw,route", [
    (288, {}, "fused"),
    (512, {}, "fused"),
    (512, dict(heads=4), "fused"),
    (320, {}, "fused"),
    (512, dict(temporal=True), "unfused"),  # kernels 2 and 6 keep 256
    (288, dict(temporal=True), "unfused"),
    (256, dict(temporal=True), "fused"),
])
def test_stw_route_takes_wide_window_layers(C, kw, route):
    """A window layer's route is its forward's and its backward's: under
    autograd too, kernels 1 and 5 take bf16 layers up to 512 channels."""
    assert fused_stw.stw_route(C, 64, 32, torch.bfloat16, **kw) == route
    # float32 keeps the narrow bodies' limit
    want32 = "fused" if C <= fused_stw.MAX_CHANNELS else "unfused"
    assert fused_stw.stw_route(C, 64, 32, torch.float32, **kw) == want32


def test_plain_backward_at_288_channels_matches_jax_interpret():
    """Two (2, 2, 2) windows of a shifted layer at 288 channels, 8 heads of
    32: the gradients of ``stw_layer_bwd``'s CPU path (autograd of the plain
    layer) against the Pallas backward kernel run in interpret mode."""
    B, T, H, W, C = 1, 2, 2, 4, 288
    heads, dh, window, shift = 8, 32, (2, 2, 2), (1, 1, 1)
    hid, N = heads * dh, 8
    rng = np.random.default_rng(21)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    x, g = f(B, T, H, W, C), f(B, T, H, W, C)
    gamma, w_qkv, w_proj, b_proj = 1 + 0.1 * f(C), 0.06 * f(C, 3 * hid), 0.06 * f(hid, C), 0.05 * f(C)
    table = 0.5 * f((2 * 2 - 1) ** 3, heads)
    bias = np.transpose(table[_relative_position_index(window).reshape(-1)].reshape(N, N, heads),
                        (2, 0, 1)).copy()
    from extdm_tpu.nn.attention import _shifted_window_mask
    m = _shifted_window_mask(T, H, W, window, shift)
    uniq, ids = np.unique(m.reshape(m.shape[0], -1), axis=0, return_inverse=True)
    masks = jnp.asarray(uniq.reshape(-1, N, N))
    want = pallas_stw._stw_bwd_impl(
        *map(jnp.asarray, (x, gamma, w_qkv, w_proj, b_proj, bias)), masks,
        jnp.asarray(ids.reshape(-1).astype(np.int32)), jnp.asarray(g), window=window, shift=shift,
        heads=heads, dim_head=dh, rotary=True, eps=1e-5, interpret=True)
    t = torch.from_numpy
    got = fused_stw.stw_layer_bwd(t(g), t(x), t(gamma), t(w_qkv.T.copy()), t(w_proj.T.copy()),
                                  t(b_proj), t(bias), window=window, shift=shift, heads=heads,
                                  dim_head=dh)
    got = [got[0], got[1], got[2].T, got[3].T, got[4], got[5]]
    for name, a, b in zip(("dx", "dgamma", "dwqkv", "dwproj", "dbproj", "dbias"), got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=2e-4 * np.abs(b).max(),
                                   err_msg=name)


def test_bias_mask_table_transposed_for_the_key_rows():
    """The key rows read bias + mask transposed in its last two dims: the
    same table, -inf past N in both."""
    bias = torch.randn(8, 16, 16)
    masks = torch.where(torch.rand(3, 16, 16) > 0.5, 0.0, -100.0)
    bm = fused_stw.bias_mask_table(bias, masks)
    bmt = bm.transpose(-1, -2).contiguous()
    assert bmt.shape == (3, 8, 64, 64) and bmt.is_contiguous()
    assert torch.equal(bmt[1, 2, 5, 7], bm[1, 2, 7, 5])
    assert torch.isinf(bmt[:, :, 16:, :]).all() and torch.isinf(bmt[:, :, :, 16:]).all()
