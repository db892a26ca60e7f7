"""Port attention layers (extdm_tpu_torch.ops.fused_stw and the UNet's
PreNormSTW / PreNormTemporalAttn) against the JAX package, on the CPU.

On the CPU the kernel wrappers run their plain versions; these are held
against ``pallas_stw``'s jnp references and its Pallas kernels in interpret
mode, float32, to 2e-4 (the JAX package's own kernel-vs-reference bound in
tests/test_pallas_stw.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extdm_tpu.models.dm import unet3d as j_unet
from extdm_tpu.nn.attention import _relative_position_index, get_window_size
from extdm_tpu.ops import pallas_stw
from extdm_tpu_torch import convert
from extdm_tpu_torch.models.dm import unet3d
from extdm_tpu_torch.ops import fused_stw, window_attn

TOL = 2e-4


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def _params(seed, C, heads, dh, table_window):
    rng = np.random.default_rng(seed)
    wd, wh, ww = table_window
    hidden = heads * dh
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return dict(gamma=1.0 + 0.1 * f(C), w_qkv=0.05 * f(C, 3 * hidden), w_proj=0.05 * f(hidden, C),
                b_proj=0.05 * f(C),
                table=0.02 * f((2 * wd - 1) * (2 * wh - 1) * (2 * ww - 1), heads),
                ln_scale=1.0 + 0.1 * f(C), ln_bias=0.1 * f(C))


def _mask_args(T, H, W, window, shift):
    from extdm_tpu.nn.attention import _shifted_window_mask

    if not any(s > 0 for s in shift):
        return None, None
    pad = lambda n, w: -(-n // w) * w  # noqa: E731
    m = _shifted_window_mask(pad(T, window[0]), pad(H, window[1]), pad(W, window[2]),
                             tuple(window), tuple(shift))
    uniq, ids = np.unique(m.reshape(m.shape[0], -1), axis=0, return_inverse=True)
    return (jnp.asarray(uniq.reshape(-1, m.shape[1], m.shape[2])),
            jnp.asarray(ids.reshape(-1).astype(np.int32)))


@pytest.mark.parametrize("shape,shift", [
    ((2, 6, 8, 8, 32), (2, 2, 2)),   # shifted, T not a multiple of the window
    ((2, 6, 8, 8, 32), (0, 0, 0)),   # unshifted: pad tokens take part as keys
    ((1, 5, 4, 4, 16), (2, 2, 2)),   # clamped H/W window: shifted in T only
])
def test_stw_plain_matches_reference_and_interpret(shape, shift):
    window, heads, dh = (4, 4, 4), 4, 8
    B, T, H, W, C = shape
    p = _params(0, C, heads, dh, window)
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    win, sh = get_window_size((T, H, W), window, shift)
    N = win[0] * win[1] * win[2]
    rel = _relative_position_index(window)[:N, :N]
    bias = np.transpose(p["table"][rel.reshape(-1)].reshape(N, N, heads), (2, 0, 1))
    kw = dict(window=win, shift=sh, heads=heads, dim_head=dh)
    ref = pallas_stw.stw_layer_reference(
        jnp.asarray(x), p["gamma"], p["w_qkv"], p["w_proj"], p["b_proj"], jnp.asarray(bias),
        *_mask_args(T, H, W, win, sh), rotary=True, **kw)
    fused = pallas_stw.fused_stw_layer(jnp.asarray(x), p["gamma"], p["w_qkv"], p["w_proj"],
                                       p["b_proj"], jnp.asarray(bias), rotary=True,
                                       interpret=True, **kw)
    t = torch.from_numpy
    out = fused_stw.fused_stw_layer(t(x), t(p["gamma"]), t(p["w_qkv"].T.copy()),
                                    t(p["w_proj"].T.copy()), t(p["b_proj"]), t(bias), **kw)
    close(out, ref)
    close(out, fused)


@pytest.mark.parametrize("shape", [(2, 6, 8, 8, 32), (1, 5, 4, 8, 16)])
def test_temporal_plain_matches_reference_and_interpret(shape):
    heads, dh = 4, 8
    B, T, H, W, C = shape
    p = _params(2, C, heads, dh, (1, 1, 1))
    x = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    bias = 0.02 * np.random.default_rng(4).normal(size=(heads, T, T)).astype(np.float32)
    kw = dict(heads=heads, dim_head=dh)
    args = (p["gamma"], p["ln_scale"], p["ln_bias"], p["w_qkv"], p["w_proj"], jnp.asarray(bias))
    ref = pallas_stw.temporal_layer_reference(jnp.asarray(x), *args, rotary=True, **kw)
    fused = pallas_stw.fused_temporal_layer(jnp.asarray(x), *args, rotary=True, interpret=True,
                                            **kw)
    t = torch.from_numpy
    out = fused_stw.fused_temporal_layer(t(x), t(p["gamma"]), t(p["ln_scale"]), t(p["ln_bias"]),
                                         t(p["w_qkv"].T.copy()), t(p["w_proj"].T.copy()), t(bias),
                                         **kw)
    close(out, ref)
    close(out, fused)


def _convert_module(kind, params):
    """Converted state dict of one flax PreNorm layer, via convert._Builder."""
    b = convert._Builder({"m": jax.tree_util.tree_map(np.asarray, params)})
    getattr(b, kind)("m", "x")
    return {k[2:]: torch.from_numpy(np.array(v)) for k, v in b.sd.items()}


@pytest.mark.parametrize("shift", [(0, 0, 0), (2, 2, 2)])
def test_prenorm_stw_module_matches_flax(shift):
    window, heads, dh = (4, 4, 4), 4, 8
    x = np.random.default_rng(5).normal(size=(2, 6, 8, 8, 32)).astype(np.float32)
    mod = j_unet.PreNormSTW(window, shift, heads, dh)
    variables = mod.init(jax.random.PRNGKey(3), jnp.asarray(x))
    ref = mod.apply(variables, jnp.asarray(x))
    port = unet3d.PreNormSTW(32, window, shift, heads, dh)
    port.load_state_dict(_convert_module("stw", variables["params"]))
    close(port(torch.from_numpy(x)).detach(), ref)


@pytest.mark.parametrize("bias_kind", ["3d", "4d", "none"])
def test_prenorm_temporal_module_matches_flax(bias_kind):
    heads, dh = 4, 8
    B, T, H, W, C = 2, 5, 4, 4, 32
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, T, H, W, C)).astype(np.float32)
    pos_bias = {"3d": 0.05 * rng.normal(size=(heads, T, T)),
                "4d": 0.05 * rng.normal(size=(heads, T, T, T)), "none": None}[bias_kind]
    jb = None if pos_bias is None else jnp.asarray(pos_bias, jnp.float32)
    mod = j_unet.PreNormTemporalAttn(heads, dh)
    variables = mod.init(jax.random.PRNGKey(5), jnp.asarray(x), jb)
    ref = mod.apply(variables, jnp.asarray(x), jb)
    port = unet3d.PreNormTemporalAttn(C, heads, dh)
    port.load_state_dict(_convert_module("temporal", variables["params"]))
    tb = None if pos_bias is None else torch.tensor(pos_bias, dtype=torch.float32)
    close(port(torch.from_numpy(x), tb).detach(), ref)


# ------------------------------------------------------------ window-major (kernel 9)
def _count_calls(monkeypatch, module, name):
    """Wrap module.name so that each call appends to the returned list."""
    calls, fn = [], getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("shape,shift", [
    ((2, 6, 8, 8, 32), (2, 2, 2)),   # shifted, T not a multiple of the window
    ((2, 6, 8, 8, 32), (0, 0, 0)),   # unshifted, ragged T: pad tokens take part as keys
    ((1, 5, 4, 8, 16), (2, 2, 2)),   # clamped H window: shifted in T and W only
])
def test_stw_window_major_plain_matches_jax(shape, shift, monkeypatch):
    """The port's window-major route on the CPU (pad, roll, ``_wm_partition``,
    ``stw_layer_wm_plain``, ``_wm_reverse``) against JAX ``_layer_impl`` with
    its window-major gate forced on, in interpret mode (``_fused_padded_wm``),
    and against ``stw_layer_reference``."""
    window, heads, dh = (4, 4, 4), 4, 8
    B, T, H, W, C = shape
    p = _params(7, C, heads, dh, window)
    x = np.random.default_rng(8).normal(size=shape).astype(np.float32)
    win, sh = get_window_size((T, H, W), window, shift)
    N = win[0] * win[1] * win[2]
    rel = _relative_position_index(window)[:N, :N]
    bias = np.transpose(p["table"][rel.reshape(-1)].reshape(N, N, heads), (2, 0, 1))
    kw = dict(window=win, shift=sh, heads=heads, dim_head=dh)
    ref = pallas_stw.stw_layer_reference(
        jnp.asarray(x), p["gamma"], p["w_qkv"], p["w_proj"], p["b_proj"], jnp.asarray(bias),
        *_mask_args(T, H, W, win, sh), rotary=True, **kw)
    routes = _count_calls(monkeypatch, pallas_stw, "_fused_padded_wm")
    monkeypatch.setattr(pallas_stw, "_window_major", lambda shifted, spatial: True)
    wm = pallas_stw.fused_stw_layer(jnp.asarray(x), p["gamma"], p["w_qkv"], p["w_proj"],
                                    p["b_proj"], jnp.asarray(bias), rotary=True, interpret=True,
                                    **kw)
    assert routes, "the JAX side did not take its window-major kernel"
    t = torch.from_numpy
    calls = _count_calls(monkeypatch, fused_stw, "stw_layer_wm_plain")
    out = fused_stw.fused_stw_layer(t(x), t(p["gamma"]), t(p["w_qkv"].T.copy()),
                                    t(p["w_proj"].T.copy()), t(p["b_proj"]), t(bias),
                                    window_major="1", **kw)
    assert calls == [1]
    close(out, ref)
    close(out, wm)


def test_wm_partition_reverse_and_masks_match_jax():
    """``_wm_partition``, ``_wm_reverse`` and ``_expand_masks`` equal the JAX
    package's, exactly; reverse undoes partition."""
    from extdm_tpu.nn.attention import _shifted_window_mask

    window = (4, 4, 4)
    xp = np.random.default_rng(9).normal(size=(2, 8, 8, 12, 5)).astype(np.float32)
    xw = fused_stw._wm_partition(torch.from_numpy(xp), window)
    np.testing.assert_array_equal(xw.numpy(), np.asarray(pallas_stw._wm_partition(jnp.asarray(xp),
                                                                                   window)))
    np.testing.assert_array_equal(
        fused_stw._wm_reverse(xw, window, xp.shape).numpy(),
        np.asarray(pallas_stw._wm_reverse(jnp.asarray(xw.numpy()), window, xp.shape)))
    np.testing.assert_array_equal(fused_stw._wm_reverse(xw, window, xp.shape).numpy(), xp)
    masks, ids = window_attn.mask_tables(8, 8, 12, window, (2, 2, 2), torch.device("cpu"))
    got = fused_stw._expand_masks(masks, ids, 2, 2, 3, 64)
    want = pallas_stw._expand_masks(jnp.asarray(masks.numpy()), jnp.asarray(ids.numpy()), 2, 2, 3,
                                    64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.reshape(-1, 64, 64).numpy(),
                                  _shifted_window_mask(8, 8, 12, window, (2, 2, 2)))


@pytest.mark.parametrize("mode", fused_stw.WINDOW_MAJOR_MODES)
def test_window_major_gate_matches_jax(mode, monkeypatch):
    monkeypatch.setenv("EXTDM_STW_WINDOW_MAJOR", mode)
    for shifted in (False, True):
        for spatial in (4, 16, 31, 32, 64):
            assert (fused_stw.window_major_gate(mode, shifted, spatial)
                    == pallas_stw._window_major(shifted, spatial)), (shifted, spatial)
    with pytest.raises(ValueError):
        fused_stw.window_major_gate("yes", False, 32)


@pytest.mark.parametrize("shift", [(0, 0, 0), (2, 2, 2)])
def test_prenorm_stw_module_window_major_matches_flax(shift):
    """The port's PreNormSTW in the window-major layout against the flax
    module (which runs its unfused path on the CPU)."""
    window, heads, dh = (4, 4, 4), 4, 8
    x = np.random.default_rng(10).normal(size=(2, 6, 8, 8, 32)).astype(np.float32)
    mod = j_unet.PreNormSTW(window, shift, heads, dh)
    variables = mod.init(jax.random.PRNGKey(4), jnp.asarray(x))
    ref = mod.apply(variables, jnp.asarray(x))
    port = unet3d.PreNormSTW(32, window, shift, heads, dh, window_major="1")
    port.load_state_dict(_convert_module("stw", variables["params"]))
    close(port(torch.from_numpy(x)).detach(), ref)


def test_stw_window_major_plain_at_320_channels_matches_jax(monkeypatch):
    """The window-major layer (``_stw_wm``: pad, roll, partition,
    ``stw_layer_wm_plain``, reverse) at 320 channels, a width kernel 9's
    bf16 body now takes, against JAX ``_layer_impl`` with its window-major
    gate forced on, in interpret mode, shifted (the expanded masks)."""
    shape, shift, window, heads, dh = (1, 4, 8, 4, 320), (2, 2, 2), (4, 4, 4), 8, 32
    B, T, H, W, C = shape
    p = _params(11, C, heads, dh, window)
    x = np.random.default_rng(12).normal(size=shape).astype(np.float32)
    win, sh = get_window_size((T, H, W), window, shift)
    N = win[0] * win[1] * win[2]
    rel = _relative_position_index(window)[:N, :N]
    bias = np.transpose(p["table"][rel.reshape(-1)].reshape(N, N, heads), (2, 0, 1))
    kw = dict(window=win, shift=sh, heads=heads, dim_head=dh)
    routes = _count_calls(monkeypatch, pallas_stw, "_fused_padded_wm")
    monkeypatch.setattr(pallas_stw, "_window_major", lambda shifted, spatial: True)
    want = pallas_stw.fused_stw_layer(jnp.asarray(x), p["gamma"], p["w_qkv"], p["w_proj"],
                                      p["b_proj"], jnp.asarray(bias), rotary=True, interpret=True,
                                      **kw)
    assert routes, "the JAX side did not take its window-major kernel"
    t = torch.from_numpy
    calls = _count_calls(monkeypatch, fused_stw, "stw_layer_wm_plain")
    out = fused_stw._stw_wm(t(x), t(p["gamma"]), t(p["w_qkv"].T.copy()), t(p["w_proj"].T.copy()),
                            t(p["b_proj"]), t(bias), eps=1e-5, **kw)
    assert calls == [1]
    close(out, want)


@pytest.mark.parametrize("C,dtype,heads,dim_head,takes", [
    (288, torch.bfloat16, 8, 32, True),    # kernel 1's body: bf16 up to 512 channels
    (512, torch.bfloat16, 4, 32, True),
    (544, torch.bfloat16, 8, 32, False),   # over 512: neither body
    (288, torch.float32, 8, 32, False),    # float32 keeps attention.cu's 256
    (256, torch.float32, 8, 32, True),
    (288, torch.bfloat16, 4, 64, False),   # dim_head 64: kernel 1's body refuses
    (96, torch.bfloat16, 2, 32, True),     # 2 heads: attention.cu's body (C <= 256)
])
def test_window_major_route_rows(C, dtype, heads, dim_head, takes, monkeypatch):
    """Which layers the window-major layout takes (kernel 9): the gate's
    mode and shape as JAX's, and a width kernel 9 runs. bf16 layers of 288
    and 512 channels, which kernel 1's body takes, now go window-major; on
    the CPU the layer then runs ``stw_layer_wm_plain``."""
    assert fused_stw._wm_takes(C, 64, heads, dim_head, dtype) == takes
    if C % 32 or dtype != torch.bfloat16 or C > 512:
        return
    calls = _count_calls(monkeypatch, fused_stw, "stw_layer_wm_plain")
    g = torch.Generator().manual_seed(C)
    hid = heads * dim_head
    args = [torch.randn(1, 4, 4, 4, C, generator=g).bfloat16(), torch.ones(C),
            0.05 * torch.randn(3 * hid, C, generator=g), 0.05 * torch.randn(C, hid, generator=g),
            torch.zeros(C), torch.zeros(heads, 64, 64)]
    out = fused_stw.fused_stw_layer(*args, window=(4, 4, 4), shift=(0, 0, 0), heads=heads,
                                    dim_head=dim_head, window_major="1")
    assert out.shape == args[0].shape and calls == ([1] if takes else [])
