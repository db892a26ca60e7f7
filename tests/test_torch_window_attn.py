"""Kernel 12 (extdm_tpu_torch.ops.window_attn) and the unfused STW and
temporal layers around it against the JAX package, on the CPU, float32.

On the CPU ``fused_window_attention`` runs ``window_attention_plain``; it
and its gradients (autograd) are held against JAX's
``fused_window_attention`` in interpret mode and ``jax.vjp`` of it (JAX's
custom_vjp: autodiff of ``_attention_reference``) to 1e-5. The unfused layers
(the route ``stw_route`` gives layers over the kernels' channel limit,
lowered here so that small layers take it) against JAX's PreNormSTW and
PreNormTemporalAttn, which run their unfused modules on the CPU, to 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extdm_tpu.models.dm import unet3d as j_unet
from extdm_tpu.nn.attention import _shifted_window_mask
from extdm_tpu.ops import pallas_attn
from extdm_tpu_torch import convert
from extdm_tpu_torch.models.dm import unet3d
from extdm_tpu_torch.ops import fused_stw, window_attn

TOL = 1e-5


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def _qkvb(seed, BW, H, N, D):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return f(BW, H, N, D) * np.float32(D ** -0.5), f(BW, H, N, D), f(BW, H, N, D), 0.1 * f(H, N, N)


@pytest.mark.parametrize("BW,H,N,D,masked", [
    (8, 2, 16, 8, False),
    (8, 2, 16, 8, True),     # 4 windows, the masks of a shifted 8 x 8 x 8 layer's 4 x 4 x 4 / 2
    (8, 2, 30, 8, False),    # temporal: N = T = 30
])
def test_plain_and_gradients_match_jax_interpret(BW, H, N, D, masked):
    q, k, v, bias = _qkvb(N + masked, BW, H, N, D)
    mask = None
    if masked:  # 4 windows of 2 x 2 x 4 tokens in a (2, 4, 8) volume shifted by (1, 1, 2)
        mask = _shifted_window_mask(2, 4, 8, (2, 2, 4), (1, 1, 2))
        assert mask.shape == (4, N, N) and len(np.unique(mask.reshape(4, -1), axis=0)) > 1
    g = np.random.default_rng(9).normal(size=q.shape).astype(np.float32)

    def jfn(q, k, v, bias):
        return pallas_attn.fused_window_attention(q, k, v, bias, mask, interpret=True)

    want, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v, bias)))
    want_grads = vjp(jnp.asarray(g))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, bias)]
    tables = None if mask is None else tuple(map(torch.from_numpy,
                                                 window_attn.dedupe_masks(mask)))
    before = window_attn.fused_window_attention.launches
    out = window_attn.fused_window_attention(*ins, tables)
    assert window_attn.fused_window_attention.launches == before  # the CPU: no kernel
    assert torch.equal(out, window_attn.window_attention_plain(*ins, tables))
    out.backward(torch.from_numpy(g))
    close(out.detach(), want)
    for t, w in zip(ins, want_grads):
        close(t.grad, w)


def test_dedupe_masks_matches_jax_and_refuses_other_devices():
    mask = _shifted_window_mask(8, 8, 8, (4, 4, 4), (2, 2, 2))
    for got, want in zip(window_attn.dedupe_masks(mask), pallas_attn.dedupe_masks(mask)):
        np.testing.assert_array_equal(got, want)
    cpu = torch.device("cpu")
    tables = window_attn.mask_tables(8, 8, 8, (4, 4, 4), (2, 2, 2), cpu)
    assert window_attn.mask_tables(8, 8, 8, (4, 4, 4), (2, 2, 2), cpu) is tables  # made once
    masks, ids = tables
    assert masks.dtype == torch.float32 and ids.dtype == torch.int32
    np.testing.assert_array_equal(masks[ids.long()].numpy(), mask)
    q, k, v, bias = (torch.from_numpy(a).to("meta") for a in _qkvb(0, 2, 2, 16, 8))
    with pytest.raises(ValueError):
        window_attn.fused_window_attention(q, k, v, bias)


@pytest.mark.parametrize("C,N,dim_head,dtype,route", [
    (256, 64, 32, torch.bfloat16, "fused"),
    (512, 64, 32, torch.bfloat16, "fused"),     # the deepest level of multi1248, a forward
    (512, 30, 32, torch.float32, "unfused"),    # its temporal layer
    (256, 65, 32, torch.float32, "unfused"),
    (256, 30, 33, torch.float32, "unfused"),
    (240, 64, 32, torch.bfloat16, "unfused"),   # bf16 rows of 32 channels
    (240, 64, 32, torch.float32, "fused"),
])
def test_stw_route_table(C, N, dim_head, dtype, route):
    assert fused_stw.stw_route(C, N, dim_head, dtype) == route


@pytest.mark.parametrize("C,N,dim_head,dtype,kw,route", [
    (512, 64, 32, torch.bfloat16, {}, "fused"),                     # multi1248's training too
    (512, 30, 32, torch.bfloat16, dict(temporal=True), "fused"),    # its temporal layer: 2 and 6
    (256, 30, 32, torch.bfloat16, dict(temporal=True), "fused"),
    (256, 64, 32, torch.bfloat16, {}, "fused"),
    (320, 64, 32, torch.bfloat16, {}, "fused"),                     # not a multiple of 128
    (320, 16, 32, torch.bfloat16, {}, "fused"),                     # a clamped window
    (544, 64, 32, torch.bfloat16, {}, "unfused"),
    (512, 64, 32, torch.float32, {}, "unfused"),                    # float32: C <= 256
    (512, 64, 16, torch.bfloat16, {}, "unfused"),                   # the wide body: dim_head 32
    (512, 64, 32, torch.bfloat16, dict(heads=2), "unfused"),        # ... and 4 or 8 heads
    (496, 64, 32, torch.bfloat16, {}, "unfused"),
])
def test_stw_route_by_kind_and_gradient(C, N, dim_head, dtype, kw, route):
    assert fused_stw.stw_route(C, N, dim_head, dtype, **kw) == route


def test_stw_route_is_the_kernels_gate():
    """``stw_route`` says "fused" exactly where the kernels' operand check
    passes: kernels 1 and 5's for a window layer, kernels 2 and 6's for the
    temporal layer (``wide``: the layer kind; with or without autograd,
    which the route does not depend on)."""
    for C in (32, 64, 240, 256, 288, 512, 544):
        for N in (30, 64, 65):
            for dh in (8, 32, 33):
                for dtype in (torch.float32, torch.bfloat16):
                    for temporal in (False, True):
                        x = torch.empty((1, 1, 1, 1, C), dtype=dtype)
                        try:
                            fused_stw._check_operands("k", x, N, 8, dh,
                                                      "temporal" if temporal else "window")
                            ok = "fused"
                        except ValueError:
                            ok = "unfused"
                        assert fused_stw.stw_route(C, N, dh, dtype, heads=8,
                                                   temporal=temporal) == ok


def _convert_module(kind, params):
    b = convert._Builder({"m": jax.tree_util.tree_map(np.asarray, params)})
    getattr(b, kind)("m", "x")
    return {k[2:]: torch.from_numpy(np.array(v)) for k, v in b.sd.items()}


def _unfused_calls(monkeypatch):
    """Lower the kernels' channel limit below the test layers' width, and
    count kernel 12's calls."""
    monkeypatch.setattr(fused_stw, "MAX_CHANNELS", 16)
    calls, fn = [], fused_stw.fused_window_attention

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return fn(*args, **kwargs)

    monkeypatch.setattr(fused_stw, "fused_window_attention", counted)
    for name in ("fused_stw_layer", "fused_temporal_layer"):
        monkeypatch.setattr(unet3d, name, lambda *a, **k: pytest.fail("the fused route ran"))
    return calls


@pytest.mark.parametrize("shape,shift", [
    ((2, 6, 8, 8, 32), (2, 2, 2)),   # shifted, T padded to 8
    ((2, 6, 8, 8, 32), (0, 0, 0)),
    ((1, 6, 4, 4, 32), (2, 2, 2)),   # a 4 x 4 frame: the window clipped, the shift along T only
])
def test_unfused_stw_layer_matches_flax(shape, shift, monkeypatch):
    calls = _unfused_calls(monkeypatch)
    window, heads, dh = (4, 4, 4), 4, 8
    x = np.random.default_rng(11).normal(size=shape).astype(np.float32)
    mod = j_unet.PreNormSTW(window, shift, heads, dh)
    variables = mod.init(jax.random.PRNGKey(6), jnp.asarray(x))
    ref = mod.apply(variables, jnp.asarray(x))
    port = unet3d.PreNormSTW(shape[-1], window, shift, heads, dh)
    port.load_state_dict(_convert_module("stw", variables["params"]))
    close(port(torch.from_numpy(x)).detach(), ref)
    windows = shape[0] * 2 * (shape[2] // 4) * (shape[3] // 4)
    assert calls == [(windows, heads, 64, dh)]


@pytest.mark.parametrize("bias_kind", ["3d", "4d", "none"])
def test_unfused_temporal_layer_matches_flax(bias_kind, monkeypatch):
    calls = _unfused_calls(monkeypatch)
    heads, dh = 4, 8
    B, T, H, W, C = 2, 30, 2, 2, 32
    rng = np.random.default_rng(12)
    x = rng.normal(size=(B, T, H, W, C)).astype(np.float32)
    pos_bias = {"3d": 0.05 * rng.normal(size=(heads, T, T)),
                "4d": 0.05 * rng.normal(size=(heads, T, T, T)), "none": None}[bias_kind]
    jb = None if pos_bias is None else jnp.asarray(pos_bias, jnp.float32)
    mod = j_unet.PreNormTemporalAttn(heads, dh)
    variables = mod.init(jax.random.PRNGKey(7), jnp.asarray(x), jb)
    ref = mod.apply(variables, jnp.asarray(x), jb)
    port = unet3d.PreNormTemporalAttn(C, heads, dh)
    port.load_state_dict(_convert_module("temporal", variables["params"]))
    tb = None if pos_bias is None else torch.tensor(pos_bias, dtype=torch.float32)
    close(port(torch.from_numpy(x), tb).detach(), ref)
    assert calls == [(B * H * W, heads, T, dh)]
