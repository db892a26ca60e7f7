"""The port's H-sharded layers (extdm_tpu_torch.parallel.spatial and the
shard routes of ops/fused_stw.py, models/dm/unet3d.py, adaptor.py and
diffusion.py) against their unsharded counterparts on the CPU, float32, at
worlds 2 and 4: each rank holds its H shard of a global input and the rows
it computes, put back together, equal the unsharded result on the global
input to 1e-5.

- The exchanges on known values: ``halo`` with zero, cyclic and clamped
  edges (and wider than a neighbour's rows), ``margin_rows``,
  ``gather_h`` / ``slice_h``, ``sum_over_model``, ``moments``;
  ``upsample_rows_2x`` on clamped rows against the bilinear resize.
- ``spatial_stw_layer`` against ``stw_layer_plain`` on the global tensor:
  aligned unshifted, shifted (1, 2, 2), H-only (0, 2, 0) (the wrap masks of
  the last shard), unaligned (HL = 2 < window_h, gathered), the unfused
  route and the window-major layout with cut masks; ``PreNormSTW`` on a
  global H <= window_h (the window clamped on the global shape, not the
  shard's); shifted and H-only layers against JAX's ``fused_stw_layer``
  under ``spatial_shard_scope(interpret=True, force=True)`` on a (1, M)
  mesh of CPU devices, 1e-5 (tests/test_spatial_fused.py's bound).
- ``spatial_temporal_layer``, ``resnet_block_sharded``, Downsample,
  Upsample, ``MotionAdaptor``, ``dynamic_threshold`` and the tiny ``Unet3D``
  forward at path 0 and 1 (with its conditioning stream).

One spawn per world serves every case (``torch_spatial_ranks.layers``: the
spawn start method, a file store, gloo, the spawn's time limit).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
import torch_spatial_ranks as sranks
from extdm_tpu.ops import pallas_stw
from extdm_tpu.parallel.mesh import make_mesh
from extdm_tpu_torch.models.dm.adaptor import MotionAdaptor
from extdm_tpu_torch.models.dm.diffusion import dynamic_threshold
from extdm_tpu_torch.models.dm.unet3d import (Downsample, PreNormSTW, Unet3D, Upsample,
                                              upsample_rows_2x)
from extdm_tpu_torch.ops.fused_resnet import resnet_block_plain
from extdm_tpu_torch.ops.fused_stw import (stw_layer_plain, stw_layer_unfused,
                                           temporal_layer_plain)
from extdm_tpu_torch.ops.resize import interpolate_bilinear
from torch_port_helpers import close

WORLDS = (2, 4)
TOL = 1e-5
HEADS, DIM_HEAD = 2, 8
WINDOW = (2, 4, 4)
LIMIT_S = 120.0


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def stw_params(rng, C, N):
    """(gamma, w_qkv, w_proj, b_proj, bias) in torch Linear layout."""
    hid = HEADS * DIM_HEAD
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return [_t(1.0 + 0.2 * f(C)), _t(0.1 * f(3 * hid, C)), _t(0.1 * f(C, hid)), _t(0.01 * f(C)),
            _t(0.05 * f(HEADS, N, N))]


# ------------------------------------------------------------------ inputs
def stw_cases(M):
    """name -> (global x, params, layer keywords) of the sharded STW layers."""
    cases = {}
    spec = {"unshifted": (4, (0, 0, 0), "fused", "0"), "shifted": (4, (1, 2, 2), "fused", "0"),
            "h_only": (4, (0, 2, 0), "fused", "0"), "unaligned": (2, (1, 2, 2), "fused", "0"),
            "unfused": (4, (1, 2, 2), "unfused", "0"),
            "window_major": (4, (1, 2, 2), "fused", "1"),
            "window_major_plain": (4, (0, 0, 0), "fused", "1")}
    for i, (name, (hl, shift, route, wm)) in enumerate(spec.items()):
        rng = _rng(10 + i)
        x = _t(rng.normal(size=(2, 4, hl * M, 8, 16)))
        cases[name] = {"x": x, "params": stw_params(rng, 16, math.prod(WINDOW)),
                       "kw": dict(window=WINDOW, shift=shift, heads=HEADS, dim_head=DIM_HEAD,
                                  route=route, window_major=wm)}
    return cases


def stw_reference(c):
    kw = dict(c["kw"])
    route, _ = kw.pop("route"), kw.pop("window_major")
    layer = stw_layer_unfused if route == "unfused" else stw_layer_plain
    return layer(c["x"], *c["params"], **kw)


def module_cases(M):
    torch.manual_seed(3)
    rng = _rng(30)
    down, up = Downsample(16), Upsample(16)
    adaptor = MotionAdaptor(8, 2, 4)
    f = lambda *s: _t(rng.normal(size=s))  # noqa: E731
    return {"down": {"cls": "down", "args": (16,), "state": down.state_dict(),
                     "x": f(2, 2, 4 * M, 6, 16)},
            "up": {"cls": "up", "args": (16,), "state": up.state_dict(),
                   "x": f(2, 2, 2 * M, 6, 16)},
            "adaptor": {"cls": "adaptor", "args": (8, 2, 4), "state": adaptor.state_dict(),
                        "x": f(2, 6, 2 * M, 6, 8) * 2.0 + 0.5}}


def module_reference(c):
    cls = {"down": Downsample, "up": Upsample, "adaptor": MotionAdaptor}[c["cls"]]
    m = cls(*c["args"])
    m.load_state_dict(c["state"])
    return m(c["x"])


UNET_KW = dict(dim=8, dim_mults=(1, 2), window_size=WINDOW, channels=3, cond_feature_dim=8,
               attn_heads=HEADS, attn_dim_head=DIM_HEAD, cond_num=2, pred_num=2, remat=False)


def unet_cases():
    out = {}
    for path in (0, 1):
        torch.manual_seed(40 + path)
        unet = Unet3D(path=path, **UNET_KW)
        rng = _rng(50 + path)
        out[f"path{path}"] = {"kwargs": dict(UNET_KW, path=path), "state": unet.state_dict(),
                              "x": _t(rng.normal(size=(2, 2, 16, 8, 3))),
                              "cond": _t(rng.normal(size=(2, 2, 16, 8, 3))),
                              "fea": _t(rng.normal(size=(2, 4, 4, 4, 8))),
                              "t": torch.tensor([5, 17])}
    return out


def unet_reference(c):
    unet = Unet3D(**c["kwargs"])
    unet.load_state_dict(c["state"])
    return unet(c["x"], c["t"], c["cond"], c["fea"])


def jax_stw(M, devices, cases):
    """JAX's fused layer under spatial_shard_scope on a (1, M) mesh for
    the shifted and H-only cases (JAX's weight layout: (in, out))."""
    mesh = make_mesh(data=1, model=M, devices=devices[:M])
    out = {}
    for name in ("shifted", "h_only"):
        c = cases[name]
        gamma, w_qkv, w_proj, b_proj, bias = (p.numpy() for p in c["params"])
        with pallas_stw.spatial_shard_scope(mesh, interpret=True, force=True):
            y = pallas_stw.fused_stw_layer(
                jnp.asarray(c["x"].numpy()), gamma, w_qkv.T, w_proj.T, b_proj, jnp.asarray(bias),
                window=WINDOW, shift=c["kw"]["shift"], heads=HEADS, dim_head=DIM_HEAD,
                rotary=True, interpret=True)
        out[name] = np.asarray(y)
    return out


def inputs(M):
    rng = _rng(M)
    f = lambda *s: _t(rng.normal(size=s))  # noqa: E731
    stw = stw_cases(M)
    torch.manual_seed(60)
    module = PreNormSTW(16, WINDOW, (1, 2, 2), HEADS, DIM_HEAD)
    C_in, C_out, groups = 8, 16, 4
    hid = (f(C_out, C_in, 1, 3, 3) * 0.2, f(C_out) * 0.1, 1.0 + 0.1 * f(C_out), 0.1 * f(C_out))
    resnet_params = (*hid, f(2, 2 * C_out) * 0.2, f(C_out, C_out, 1, 3, 3) * 0.1, f(C_out) * 0.1,
                     1.0 + 0.1 * f(C_out), 0.1 * f(C_out), f(C_out, C_in, 1, 1, 1) * 0.3,
                     f(C_out) * 0.1)
    T = 5
    temporal_params = (1.0 + 0.2 * f(16), 1.0 + 0.1 * f(16), 0.05 * f(16),
                       0.1 * f(3 * HEADS * DIM_HEAD, 16), 0.1 * f(16, HEADS * DIM_HEAD),
                       0.05 * f(HEADS, T, T))
    return {
        "exchanges": {"x": torch.arange(12.0 * M).reshape(1, 2, 3 * M, 2, 1),
                      "stats": f(2, 3, 2 * M, 4, 5) * 2.0 + 1.0},
        "stw": stw,
        "jax_stw": {k: stw[k] for k in ("shifted", "h_only")},
        "stw_module": {"kwargs": dict(dim=16, window_size=WINDOW, shift_size=(1, 2, 2),
                                      heads=HEADS, dim_head=DIM_HEAD),
                       "state": module.state_dict(), "x": f(2, 4, 4, 8, 16)},
        "temporal": {"x": f(2, T, 2 * M, 4, 16), "params": temporal_params,
                     "kw": dict(heads=HEADS, dim_head=DIM_HEAD)},
        "resnet": {"x": f(2, 3, 2 * M, 6, C_in), "params": resnet_params, "groups": groups},
        "modules": module_cases(M),
        "threshold": {"x0": f(3, 2, 2 * M, 4, 3) * 3.0},
        "unet": unet_cases(),
    }


@pytest.fixture(scope="module")
def runs(devices, tmp_path_factory):
    """Per world: the inputs, JAX's sharded layers, and one spawn of the
    ranks running every case."""
    out = {}
    for M in WORLDS:
        inp = inputs(M)
        tmp = tmp_path_factory.mktemp(f"spatial{M}")
        torch.save(inp, tmp / "inputs.pt")
        jax_out = jax_stw(M, devices, inp["stw"])
        ranks.spawn(sranks.layers, M, str(tmp / "store"), str(tmp / "inputs.pt"), str(tmp),
                    limit_s=LIMIT_S)
        got = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(M)]
        out[M] = {"inp": inp, "got": got, "jax": jax_out}
    return out


def joined(run, case, name=None):
    """The ranks' shards of one output, put back together along H."""
    parts = [g[case] if name is None else g[case][name] for g in run["got"]]
    return torch.cat(parts, dim=2)


# ------------------------------------------------------------------ tests
def _rows(x, lo, hi, edge):
    """Rows [lo, hi) of x along dim 2: wrapped, zero or the edge rows
    repeated past the edges."""
    H = x.shape[2]
    idx = np.arange(lo, hi)
    out = x[:, :, np.clip(idx, 0, H - 1) if edge == "clamp" else idx % H].clone()
    if edge == "zero":
        out[:, :, (idx < 0) | (idx >= H)] = 0
    return out


@pytest.mark.parametrize("M", WORLDS)
def test_exchanges_on_known_values(runs, M):
    run = runs[M]
    x = run["inp"]["exchanges"]["x"]
    stats = run["inp"]["exchanges"]["stats"]
    mean = stats.mean(dim=(1, 2, 3), keepdim=True)
    for r, g in enumerate(run["got"]):
        e = g["exchanges"]
        assert g["mesh"] == (0, r)
        lo, hi = 3 * r, 3 * r + 3
        assert torch.equal(e["halo_zero"], _rows(x, lo - 2, hi + 1, "zero"))
        assert torch.equal(e["halo_cyclic"], _rows(x, lo - 1, hi + 2, "cyclic"))
        assert torch.equal(e["halo_wide"], _rows(x, lo - 4, hi, "zero"))
        assert e["bf16"].dtype == torch.bfloat16
        assert torch.equal(e["bf16"], _rows(x, lo - 1, hi + 1, "cyclic").bfloat16())
        assert torch.equal(e["gathered"], x)
        assert e["summed"].item() == M * (M + 1) / 2
        assert e["n"] == stats[0, :, :, :, 0].numel()
        close(e["mean"], mean, TOL)
        close(e["m2"], ((stats - mean) ** 2).sum(dim=(1, 2, 3), keepdim=True), TOL)


@pytest.mark.parametrize("M", WORLDS)
def test_clamped_halo_and_margin_rows_on_known_values(runs, M):
    """The "clamp" edge repeats the global first and last rows, also past a
    neighbour's rows; ``margin_rows`` cuts the same rows from a whole
    tensor with no exchange."""
    run = runs[M]
    x = run["inp"]["exchanges"]["x"]
    for r, g in enumerate(run["got"]):
        e = g["exchanges"]
        lo, hi = 3 * r, 3 * r + 3
        assert torch.equal(e["halo_clamp"], _rows(x, lo - 2, hi + 1, "clamp"))
        assert torch.equal(e["halo_clamp_wide"], _rows(x, lo - 4, hi + 1, "clamp"))
        assert torch.equal(e["margin_clamp"], _rows(x, lo - 1, hi + 2, "clamp"))


@pytest.mark.parametrize("rows", [4, 6])
def test_upsample_rows_2x_is_the_bilinear_resize(rows):
    """A 2x bilinear resize (align_corners=False) of (B, T, H, W, C), cut
    into row blocks: each block's output rows from the block with one
    clamped row above and below, the W half by interpolate."""
    x = torch.randn(2, 3, 12, 5, 4, generator=torch.Generator().manual_seed(5))
    want = interpolate_bilinear(x.reshape(6, 12, 5, 4), (24, 10)).reshape(2, 3, 24, 10, 4)
    for lo in range(0, 12, rows):
        block = upsample_rows_2x(_rows(x, lo - 1, lo + rows + 1, "clamp"))
        got = interpolate_bilinear(block.reshape(6, 2 * rows, 5, 4), (2 * rows, 10))
        close(got.reshape(2, 3, 2 * rows, 10, 4), want[:, :, 2 * lo:2 * (lo + rows)], 1e-6)


@pytest.mark.parametrize("M", WORLDS)
@pytest.mark.parametrize("case", ["unshifted", "shifted", "h_only", "unaligned", "unfused",
                                  "window_major", "window_major_plain"])
def test_spatial_stw_layer_matches_the_global_layer(runs, M, case):
    run = runs[M]
    c = run["inp"]["stw"][case]
    close(joined(run, "stw", case), stw_reference(c), TOL)


@pytest.mark.parametrize("M", WORLDS)
@pytest.mark.parametrize("case", ["shifted", "h_only"])
def test_spatial_stw_layer_matches_jax_spatial_scope(runs, M, case):
    run = runs[M]
    close(joined(run, "jax_stw", case), run["jax"][case], TOL)


@pytest.mark.parametrize("M", WORLDS)
def test_prenorm_stw_clamps_the_window_on_the_global_shape(runs, M):
    """Global H = 4 <= window_h: the window stays 4 high and the H shift 0,
    though each shard holds 4 / M rows."""
    run = runs[M]
    c = run["inp"]["stw_module"]
    layer = PreNormSTW(**c["kwargs"])
    layer.load_state_dict(c["state"])
    assert c["x"].shape[2] // M < WINDOW[1]
    with torch.no_grad():
        close(joined(run, "stw_module", "y"), layer(c["x"]), TOL)


@pytest.mark.parametrize("M", WORLDS)
def test_spatial_temporal_layer_is_local(runs, M):
    run = runs[M]
    c = run["inp"]["temporal"]
    close(joined(run, "temporal", "y"), temporal_layer_plain(c["x"], *c["params"], **c["kw"]),
          TOL)


@pytest.mark.parametrize("M", WORLDS)
def test_sharded_resnet_block_matches_the_plain_block(runs, M):
    run = runs[M]
    c = run["inp"]["resnet"]
    close(joined(run, "resnet", "y"), resnet_block_plain(c["x"], *c["params"], groups=c["groups"]),
          TOL)


@pytest.mark.parametrize("M", WORLDS)
@pytest.mark.parametrize("case", ["down", "up", "adaptor"])
def test_sharded_resample_and_adaptor_match(runs, M, case):
    run = runs[M]
    with torch.no_grad():
        close(joined(run, "modules", case), module_reference(run["inp"]["modules"][case]), TOL)


@pytest.mark.parametrize("M", WORLDS)
def test_dynamic_threshold_takes_the_global_quantile(runs, M):
    run = runs[M]
    x0 = run["inp"]["threshold"]["x0"]
    assert (x0.abs().reshape(3, -1).quantile(0.9, dim=-1) > 1).all()
    close(joined(run, "threshold", "y"), dynamic_threshold(x0), TOL)


@pytest.mark.parametrize("M", WORLDS)
@pytest.mark.parametrize("path", [0, 1])
def test_unet_forward_on_shards_matches_the_unsharded_forward(runs, M, path):
    run = runs[M]
    c = run["inp"]["unet"][f"path{path}"]
    with torch.no_grad():
        want = unet_reference(c)
    close(joined(run, "unet", f"path{path}"), want, TOL)
