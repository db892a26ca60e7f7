"""Port diffusion model (extdm_tpu_torch.models.dm) against the JAX package
on the CPU, float32: schedule buffers, the DDIM grid, dynamic thresholding,
the Unet3D forward (cond_only and with the cached cond stream) at dim 16,
dim_mults (1, 2), 2 heads x 8, and the whole sampler (encode -> DDIM ->
decode) at ddim_eta=0 with a shared init_noise, which makes the rollout
deterministic in both packages.

Tolerances: the schedule matches exactly (same float64 numpy, cast once);
the UNet forward to 2e-4 (IMPLEMENTATION_NOTES.md:184, the JAX package's
own parity bound with the reference); the sampled latents and decoded
pixels to 1e-3, since three chained UNet forwards and the dynamic threshold
carry the forward's float32 differences along the rollout.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extdm_tpu.models.dm import diffusion as j_diff
from extdm_tpu.models.dm.flow_diffusion import FlowDiffusion as JFlowDiffusion
from extdm_tpu.models.dm.flow_diffusion import FlowDiffusionConfig as JConfig
from extdm_tpu_torch import convert
from extdm_tpu_torch.models.dm import diffusion
from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusion, FlowDiffusionConfig
from torch_port_helpers import close, random_variables, tiny_flow_params

CFG = dict(cond_frames=2, pred_frames=2, frame_shape=32, timesteps=1000, sampling_timesteps=3,
           ddim_eta=0.0, dim=16, dim_mults=(1, 2), attn_heads=2, attn_dim_head=8)


def test_schedule_buffers_equal():
    s, js = diffusion.DiffusionSchedule.create(1000), j_diff.DiffusionSchedule.create(1000)
    for f in dataclasses.fields(s):
        np.testing.assert_array_equal(getattr(s, f.name), getattr(js, f.name))


@pytest.mark.parametrize("steps", [10, 3, 50])
def test_ddim_time_pairs_equal(steps):
    np.testing.assert_array_equal(diffusion.ddim_time_pairs(1000, steps),
                                  j_diff.ddim_time_pairs(1000, steps))


def test_dynamic_threshold():
    x0 = (np.random.default_rng(0).normal(size=(3, 4, 5, 6)) * [[[[0.5]]], [[[2.0]]], [[[4.0]]]])
    x0 = x0.astype(np.float32)
    close(diffusion.dynamic_threshold(torch.from_numpy(x0)),
          j_diff.dynamic_threshold(jnp.asarray(x0)), 1e-6)


@pytest.fixture(scope="module")
def models():
    jfd = JFlowDiffusion(JConfig(flow_params=tiny_flow_params(), remat=False, **CFG))
    shapes = jax.eval_shape(jfd.init_variables, jax.random.PRNGKey(0))
    lfae_vars = random_variables(dict(shapes[0]), 1)
    unet_vars = {"params": random_variables(dict(shapes[1]["params"]), 2)}
    fd = FlowDiffusion(FlowDiffusionConfig(flow_params=tiny_flow_params(), **CFG), device="cpu")
    fd.lfae.load_state_dict(convert.lfae_state_dict(lfae_vars))
    fd.unet.load_state_dict(convert.unet_state_dict(unet_vars["params"]))
    return jfd, lfae_vars, unet_vars, fd


def test_unet_forward_and_cond_cache(models):
    jfd, _, unet_vars, fd = models
    rng = np.random.default_rng(3)
    tc, tp = CFG["cond_frames"], CFG["pred_frames"]
    x = rng.normal(size=(2, tp, 16, 16, 3)).astype(np.float32)
    cond = rng.normal(size=(2, tc, 16, 16, 3)).astype(np.float32)
    fea = rng.normal(size=(2, tc + tp, 8, 8, 32)).astype(np.float32)
    t = np.array([999, 17], np.int32)

    @jax.jit  # one compiled program: far quicker on the CPU than three eager applies
    def reference(v, x, t, c, f):
        cache = jfd.unet.apply(v, x, t, c, f, cond_only=True)
        return (cache, jfd.unet.apply(v, x, t, c, f),
                jfd.unet.apply(v, x, t, c, None, cond_cache=cache))

    ref_cache, ref, ref_cached = reference(unet_vars, *map(jnp.asarray, (x, t, cond, fea)))
    p = dict(x=torch.from_numpy(x), t=torch.from_numpy(t).long(), c=torch.from_numpy(cond),
             f=torch.from_numpy(fea))
    with torch.no_grad():
        cache = fd.unet(p["x"], p["t"], p["c"], p["f"], cond_only=True)
        out = fd.unet(p["x"], p["t"], p["c"], p["f"])
        out_cached = fd.unet(p["x"], p["t"], p["c"], None, cond_cache=cache)
    close(cache, ref_cache, 2e-4)
    close(out, ref, 2e-4)
    close(out_cached, ref_cached, 2e-4)


def test_sampler_end_to_end(models):
    jfd, lfae_vars, unet_vars, fd = models
    rng = np.random.default_rng(4)
    tc, tp = CFG["cond_frames"], CFG["pred_frames"]
    cond = rng.uniform(size=(2, tc, 32, 32, 3)).astype(np.float32)
    noise = rng.normal(size=(2, tp, 16, 16, 3)).astype(np.float32)
    ref = jfd.make_sampler(lfae_vars, unet_vars)(jax.random.PRNGKey(0), jnp.asarray(cond),
                                                 init_noise=jnp.asarray(noise))
    out = fd.make_sampler()(torch.Generator().manual_seed(0), torch.from_numpy(cond),
                            init_noise=torch.from_numpy(noise))
    assert set(out) == set(ref)
    for key in ("sample_vid_grid", "sample_vid_conf", "real_vid_grid", "real_vid_conf",
                "sample_out_vid", "sample_warped_vid"):
        assert out[key].shape == ref[key].shape, key
        close(out[key], ref[key], 1e-3)


@pytest.mark.parametrize("name", ["kth", "smmnist", "shapes"])
@pytest.mark.parametrize("arch", ["w_ref_u22/ada_u22", "multi/wo_ref"])
def test_config_from_yaml_matches_jax(name, arch):
    """The port's dm_config_from_yaml builds the JAX package's config. The
    port's STW layout field, which the JAX package reads from
    EXTDM_STW_WINDOW_MAJOR, keeps that variable's default."""
    from extdm_tpu import config as j_config
    from extdm_tpu_torch import config

    raw = config.load_config(f"configs/DM/{name}.yaml")
    port = dataclasses.asdict(config.dm_config_from_yaml(raw, arch))
    ref = dataclasses.asdict(j_config.dm_config_from_yaml(raw, arch))
    assert port.pop("stw_window_major") == "0"
    assert port == {k: v for k, v in ref.items() if k in port}


def test_kth_preset_matches_bench():
    """kth_sampling_config is bench.py's KTH sampling configuration."""
    import ast
    from pathlib import Path

    from extdm_tpu_torch.config import KTH_FLOW_PARAMS, kth_sampling_config

    bench = ast.parse((Path(__file__).resolve().parents[1] / "bench.py").read_text())
    node = next(n for n in bench.body if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", "") == "KTH_FLOW_PARAMS")
    namespace = {}
    exec(compile(ast.Module([node], []), "bench.py", "exec"), namespace)  # the dict(...) alone
    assert KTH_FLOW_PARAMS == namespace["KTH_FLOW_PARAMS"]
    cfg = kth_sampling_config()
    assert (cfg.cond_frames, cfg.pred_frames, cfg.frame_shape, cfg.sampling_timesteps, cfg.dim,
            tuple(cfg.dim_mults), cfg.attn_heads, cfg.attn_dim_head) == (10, 20, 64, 10, 64,
                                                                          (1, 2, 4, 4), 8, 32)
