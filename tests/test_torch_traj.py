"""The trajectory-warp denoiser family (the ``w_ref/traj`` preset:
``Unet3D(conditioning="trajwarp")`` with ``TrajWarp``) of the port against
the JAX package on the CPU, float32, at a tiny size: the LFAE of
torch_port_helpers, 32 px frames, tc = tp = 2, dim 16, dim_mults (1, 2),
2 heads of 8, window (2, 4, 4) (N = 32 tokens, shift (1, 2, 2)), adaptors
from level 1 (the preset's from level 2: with two levels, so that a down
level's adaptor is in the test); weights carried across by ``convert.py``.

- ``TrajWarp`` alone (4 heads of 8 over 32 channels), 2e-4.
- The trajwarp ``Unet3D`` forward, 2e-4 (tests/test_torch_dm.py's bound).
- A trajwarp DDIM sampler call at ddim_eta 0 with a shared ``init_noise``
  (deterministic in both packages): ``make_sampler(decode=False)``'s latents
  against JAX's encode + ``diffusion.sample``, 2e-4. ``cond_cache`` is None
  for this family, so TrajWarp runs at every step. (The decode is the
  adaptor family's, held in tests/test_torch_dm.py.)
- The train step's loss (1e-5) and every UNet gradient (2e-4 of its max),
  the port fed JAX's draw of t and noise, both on the port LFAE's latents.
- ``train_dm.main`` with a tiny trajwarp preset for 2 steps.

The JAX side runs under one ``jax.jit`` per program, compiled at XLA's
lowest optimisation level (test_torch_jobs.FAST_COMPILE).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extdm_tpu.models.dm.adaptor import TrajWarp as JTrajWarp
from extdm_tpu.models.dm.flow_diffusion import FlowDiffusion as JFlowDiffusion
from extdm_tpu.models.dm.flow_diffusion import FlowDiffusionConfig as JConfig
from extdm_tpu_torch import config, convert
from extdm_tpu_torch.models.dm.adaptor import TrajWarp
from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusion, FlowDiffusionConfig
from extdm_tpu_torch.train import train_dm
from extdm_tpu.models.dm.flow_diffusion import LFAE as JLFAE
from extdm_tpu_torch.models.dm.diffusion import ddim_time_pairs
from test_torch_jobs import fast_jit, loss_records, tiny_yaml
from torch_port_helpers import close, random_variables, tiny_flow_params

t_ = torch.from_numpy
TRAJ = dict(use_ref_features=True, conditioning="trajwarp", down_adaptor_from_level=1,
            window_size=(2, 4, 4), dim=16, dim_mults=(1, 2), attn_heads=2, attn_dim_head=8)
CFG = dict(cond_frames=2, pred_frames=2, frame_shape=32, timesteps=1000, sampling_timesteps=3,
           ddim_eta=0.0, **TRAJ)


def test_traj_preset_is_the_jax_one():
    from extdm_tpu import config as j_config

    assert config.ARCH_PRESETS["w_ref/traj"] == j_config.ARCH_PRESETS["w_ref/traj"]
    cfg = config.kth_traj_config()
    assert (cfg.conditioning, cfg.window_size, cfg.down_adaptor_from_level, cfg.dim,
            tuple(cfg.dim_mults), cfg.dtype) == ("trajwarp", (2, 4, 4), 2, 64, (1, 2, 4, 4),
                                                 torch.bfloat16)


def test_trajwarp_matches_jax():
    rng = np.random.default_rng(0)
    B, tc, tp, H, C, heads = 2, 2, 3, 4, 32, 4
    xp = rng.normal(size=(B, tp, 2 * H, 2 * H, C)).astype(np.float32)
    f = rng.normal(size=(B, tc + tp, H, H, C)).astype(np.float32)
    jm = JTrajWarp(tc, tp, heads=heads)
    params = random_variables(jax.eval_shape(jm.init, jax.random.PRNGKey(0), xp, f)["params"], 3)
    want = jm.apply({"params": params}, jnp.asarray(xp), jnp.asarray(f))

    m = TrajWarp(C, tc, tp, heads)
    m.load_state_dict(convert.trajwarp_state_dict(params))
    with torch.no_grad():
        got = m(t_(xp), t_(f))
    assert got.shape == (B, tc + tp, H, H, C)
    close(got, want, 2e-4)


@pytest.fixture(scope="module")
def models():
    jfd = JFlowDiffusion(JConfig(flow_params=tiny_flow_params(), remat=False, **CFG))
    shapes = jax.eval_shape(jfd.init_variables, jax.random.PRNGKey(0))
    lfae_vars = random_variables(dict(shapes[0]), 1)
    unet_params = random_variables(dict(shapes[1]["params"]), 2)
    fd = FlowDiffusion(FlowDiffusionConfig(flow_params=tiny_flow_params(), **CFG), device="cpu")
    fd.lfae.load_state_dict(convert.lfae_state_dict(lfae_vars))
    fd.unet.load_state_dict(convert.unet_state_dict(unet_params))
    return jfd, lfae_vars, unet_params, fd


def test_unet_has_the_jax_parameters(models):
    jfd, _, unet_params, fd = models
    assert sorted(convert.unet_state_dict(unet_params)) == sorted(fd.unet.state_dict())
    assert "init_traj" in unet_params and "cond_adaptor" not in unet_params
    assert {"down1_adaptor", "mid_adaptor"} <= set(unet_params)
    assert not {"down0_adaptor", "up0_adaptor", "up1_adaptor"} & set(unet_params)


def test_trajwarp_sampler_matches_jax(models):
    jfd, lfae_vars, unet_params, fd = models
    tc, tp = CFG["cond_frames"], CFG["pred_frames"]
    rng = np.random.default_rng(4)
    cond = rng.uniform(size=(2, tc, 32, 32, 3)).astype(np.float32)
    noise = rng.normal(size=(2, tp, 16, 16, 3)).astype(np.float32)

    def sample(lv, uv, cond, noise):  # JAX make_sampler's encode and ddim programs
        enc = jfd.lfae.apply(lv, cond, tc, method=JLFAE.encode_video)
        fea = jfd.lfae.apply(lv, cond, tc, tp, method=JLFAE.ref_features)
        x_cond = jfd.latents_from_encode(enc)
        assert jfd.cond_cache(uv, x_cond, fea) is None
        return enc["flow"], jfd.diffusion.sample(jfd.denoise_fn(uv), jax.random.PRNGKey(0),
                                                 x_cond, tp, fea, init_noise=noise)

    args = (lfae_vars, {"params": unet_params}, jnp.asarray(cond), jnp.asarray(noise))
    flow, pred = fast_jit(sample, *args)(*args)
    calls = []
    hook = fd.unet.init_traj.register_forward_hook(lambda *a: calls.append(1))
    out = fd.make_sampler(decode=False)(torch.Generator().manual_seed(0), t_(cond),
                                        init_noise=t_(noise))
    hook.remove()
    assert len(calls) == len(ddim_time_pairs(1000, CFG["sampling_timesteps"]))  # every step
    assert sorted(out) == ["real_vid_conf", "real_vid_grid", "sample_vid_conf",
                           "sample_vid_grid"]
    close(out["real_vid_grid"], flow, 2e-4)
    close(out["sample_vid_grid"][:, tc:], pred[..., :2], 2e-4)
    close(out["sample_vid_conf"][:, tc:], (pred[..., 2:3] + 1) * 0.5, 2e-4)


def _jax_draws(key, b, shape):
    key_t, key_noise = jax.random.split(key)
    t = jax.random.randint(key_t, (b,), 0, 1000)
    noise = jax.random.normal(key_noise, shape, jnp.float32)
    return t_(np.array(t)).long(), t_(np.array(noise))


@pytest.fixture(scope="module")
def unet_runs(models):
    """One JAX program (one compile) for the forward and the gradient tests:
    the UNet's forward on random inputs, and the step's loss and UNet
    gradients on the latents and features that the port's frozen LFAE gives
    for a clip (its parity with JAX's is tests/test_torch_lfae.py's)."""
    jfd, lfae_vars, unet_params, _ = models
    tc, tp = CFG["cond_frames"], CFG["pred_frames"]
    rng = np.random.default_rng(3)
    fwd = dict(x=rng.normal(size=(2, tp, 16, 16, 3)), cond=rng.normal(size=(2, tc, 16, 16, 3)),
               fea=rng.normal(size=(2, tc + tp, 8, 8, 32)))
    fwd = {k: v.astype(np.float32) for k, v in fwd.items()}
    fwd["t"] = np.array([999, 17], np.int32)
    video = rng.uniform(size=(2, tc + tp, 32, 32, 3)).astype(np.float32)
    fd = FlowDiffusion(FlowDiffusionConfig(flow_params=tiny_flow_params(), remat=True, **CFG),
                       device="cpu")
    fd.lfae.load_state_dict(convert.lfae_state_dict(lfae_vars))
    fd.unet.load_state_dict(convert.unet_state_dict(unet_params))
    with torch.no_grad():
        frames = fd.latents_from_encode(fd.lfae.encode_video(t_(video), tc)).numpy()
        fea = fd.lfae.ref_features(t_(video), tc, tp).numpy()
    key = jax.random.PRNGKey(21)

    def program(p, fwd, frames, fea):
        out = jfd.unet.apply({"params": p}, fwd["x"], fwd["t"], fwd["cond"], fwd["fea"])

        def loss(p):
            return jfd.diffusion.p_losses(jfd.denoise_fn({"params": p}), key, frames[:, :tc],
                                          frames[:, tc:], fea)[0]
        return out, jax.value_and_grad(loss)(p)

    args = (unet_params, {k: jnp.asarray(v) for k, v in fwd.items()}, jnp.asarray(frames),
            jnp.asarray(fea))
    out, (loss, grads) = fast_jit(program, *args)(*args)
    return dict(fwd=fwd, out=out, video=video, key=key, fd=fd, loss=loss,
                grads=convert.unet_state_dict(grads))


def test_trajwarp_unet_forward_matches_jax(models, unet_runs):
    fd, fwd = models[3], unet_runs["fwd"]
    args = (t_(fwd["x"]), t_(fwd["t"]).long(), t_(fwd["cond"]), t_(fwd["fea"]))
    with torch.no_grad():
        got = fd.unet(*args)
        assert fd.cond_cache(args[2], args[3]) is None
        with pytest.raises(ValueError, match="no cond cache"):
            fd.unet(*args, cond_only=True)
    close(got, unet_runs["out"], 2e-4)


def test_trajwarp_train_step_gradients_match_jax(unet_runs):
    """JAX's ``p_losses`` through its UNet against the port's
    ``FlowDiffusion.loss`` (remat on, as the step runs it) fed JAX's t and
    noise."""
    fd, tp = unet_runs["fd"], CFG["pred_frames"]
    t, noise = _jax_draws(unet_runs["key"], 2, (2, tp, 16, 16, 3))
    loss, _ = fd.loss(None, t_(unet_runs["video"]), t=t, noise=noise)
    loss.backward()
    close(loss.detach(), unet_runs["loss"], 1e-5)
    jgrads = unet_runs["grads"]
    names = [n for n, _ in fd.unet.named_parameters()]
    assert sorted(names) == sorted(jgrads)
    for name, p in fd.unet.named_parameters():
        want = np.asarray(jgrads[name])
        tol = 2e-4 * max(np.abs(want).max(), 1e-12)
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0, atol=tol, err_msg=name)


def test_dm_job_trains_the_trajwarp_preset(tmp_path, monkeypatch):
    monkeypatch.setitem(config.ARCH_PRESETS, "tiny_traj", TRAJ)
    cfg_path, raw = tiny_yaml(tmp_path)
    fdc = config.dm_config_from_yaml(raw, arch="tiny_traj")
    assert fdc.conditioning == "trajwarp" and fdc.window_size == (2, 4, 4)
    log = str(tmp_path / "dm")
    assert train_dm.main(["--config", cfg_path, "--arch", "tiny_traj", "--device", "cpu",
                          "--synthetic_videos", "4", "--batch_size", "2", "--max_steps", "2",
                          "--valid_every", "0", "--log_dir", log]) == 0
    recs = loss_records(log, "loss")
    assert [r["step"] for r in recs] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in recs)
