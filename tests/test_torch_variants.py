"""The remaining sampler and model variants of the port against the JAX
package on the CPU, float32, at tiny sizes; weights carried across by
``convert.py``.

- ``GaussianDiffusion.interpolate`` fed JAX's draws (the mixing noise and
  each step's normal from its split-key chain), a small denoiser written in
  both frameworks standing in for the UNet: 1e-5.
- ``Unet3D`` with ``init_dim`` != ``dim``, ``use_final_activation``,
  ``cond_dim`` and ``learn_null_cond``: the forward with a condition, with
  ``null_cond_mask`` on some samples and with no condition; and
  ``guided_denoise_fn`` at scales 0, 1 and 2: 2e-4 (the UNet's bound,
  tests/test_torch_dm.py).
- ``FlowDiffusion.sample_video`` (DDIM at eta 0, so that only x_T is drawn:
  JAX's draw is given to the port) against JAX's ``sample_video``, and
  ``make_sampler(decode=False)``, which must give sample_video's four latent
  keys bit for bit and no decoded ones: 1e-3 (tests/test_torch_dm.py's
  sampler bound).
- ``FourierEncoding3D`` (the same numpy frequencies from ``seed``): 1e-5.
- F5: ``dm_config_from_yaml`` takes the yaml's ``loss_type`` in both
  packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from extdm_tpu import config as j_config
from extdm_tpu.models.dm import diffusion as j_diff
from extdm_tpu.models.dm.fourier import FourierEncoding3D as JFourier
from extdm_tpu.models.dm.flow_diffusion import FlowDiffusion as JFlowDiffusion
from extdm_tpu.models.dm.flow_diffusion import FlowDiffusionConfig as JConfig
from extdm_tpu.models.dm.unet3d import Unet3D as JUnet3D
from extdm_tpu_torch import config, convert
from extdm_tpu_torch.models.dm import diffusion
from extdm_tpu_torch.models.dm.fourier import FourierEncoding3D
from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusion, FlowDiffusionConfig
from extdm_tpu_torch.models.dm.unet3d import Unet3D
from test_torch_jobs import fast_jit
from torch_port_helpers import close, random_variables, tiny_flow_params

t_ = torch.from_numpy


# ------------------------------------------------------------ interpolate
def _denoise_jax(x, t, cond, fea):
    return jnp.tanh(0.3 * x + 0.1 * cond.mean(axis=1, keepdims=True)) + 1e-3 * t[:, None, None,
                                                                              None, None]


def _denoise_torch(x, t, cond, fea):
    return (torch.tanh(0.3 * x + 0.1 * cond.mean(dim=1, keepdim=True))
            + 1e-3 * t[:, None, None, None, None].float())


@pytest.mark.parametrize("t,lam", [(None, 0.5), (5, 0.25)])
def test_interpolate_matches_jax_with_its_draws(t, lam):
    rng = np.random.default_rng(0)
    cond, x1, x2 = (rng.normal(size=(2, n, 4, 4, 3)).astype(np.float32) for n in (2, 3, 3))
    key = jax.random.PRNGKey(9)
    jd = j_diff.GaussianDiffusion(j_diff.DiffusionSchedule.create(8))
    want = np.asarray(jd.interpolate(_denoise_jax, key, *map(jnp.asarray, (cond, x1, x2)),
                                     t=t, lam=lam))
    steps = 7 if t is None else t
    key, k1 = jax.random.split(key)
    noise = np.array(jax.random.normal(k1, x1.shape, jnp.float32))
    noises = []
    for _ in range(steps):
        key, nkey = jax.random.split(key)
        noises.append(t_(np.array(jax.random.normal(nkey, x1.shape, jnp.float32))))

    d = diffusion.GaussianDiffusion(diffusion.DiffusionSchedule.create(8))
    got = d.interpolate(_denoise_torch, None, t_(cond), t_(x1), t_(x2), t=t, lam=lam,
                        noise=t_(noise), noises=noises)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    drawn = d.interpolate(_denoise_torch, torch.Generator().manual_seed(0), t_(cond), t_(x1),
                          t_(x2), t=t, lam=lam)
    assert drawn.shape == x1.shape and torch.isfinite(drawn).all()


# ------------------------------------------- UNet options and guidance
UNET = dict(dim=8, dim_mults=(1,), window_size=(2, 4, 4), attn_heads=2, attn_dim_head=4,
            cond_num=2, pred_num=2, use_ref_features=False, init_dim=16,
            use_final_activation=True, cond_dim=6, learn_null_cond=True)


@pytest.fixture(scope="module")
def guided():
    """The JAX and port UNets with every option, on the same weights, and
    one jitted JAX apply (the mask always given: all False is the plain
    condition)."""
    jm = JUnet3D(remat=False, **UNET)
    rng = np.random.default_rng(1)
    inputs = dict(x=rng.normal(size=(3, 2, 8, 8, 3)), cond_frames=rng.normal(size=(3, 2, 8, 8, 3)),
                  cond=rng.normal(size=(3, 6)))
    inputs = {k: v.astype(np.float32) for k, v in inputs.items()}
    inputs["t"] = np.array([999, 3, 400], np.int32)
    mask0 = jnp.zeros((3,), bool)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), inputs["x"], inputs["t"],
                            inputs["cond_frames"], cond=inputs["cond"], null_cond_mask=mask0)
    params = random_variables(shapes["params"], 4)
    assert params["null_cond_emb"].shape == (1, 6)

    def apply(p, x, t, c, cond, mask):
        return jm.apply({"params": p}, x, t, c, None, cond=cond, null_cond_mask=mask)

    j_in = (jnp.asarray(inputs["x"]), jnp.asarray(inputs["t"]), jnp.asarray(inputs["cond_frames"]),
            jnp.asarray(inputs["cond"]))
    japply = fast_jit(apply, params, *j_in, mask0)
    unet = Unet3D(remat=False, **UNET)
    unet.load_state_dict(convert.unet_state_dict(params))
    unet.eval()
    return params, inputs, j_in, japply, unet


def test_unet_options_match_jax(guided):
    """init_dim 16 != dim 8 (the init conv, the first level's input and the
    final blocks' 2 x 16 input), tanh on the output, the time embedding
    widened by cond_dim 6 in every resnet block; with the condition, with
    the null embedding on sample 1 (null_cond_mask), and with no condition
    (the null embedding everywhere)."""
    params, inputs, j_in, japply, unet = guided
    assert unet.init_conv.out_channels == 16 and unet.downs[0][0].block1.proj.in_channels == 16
    assert unet.final_conv[0].block1.proj.in_channels == 32
    assert unet.downs[0][0].mlp[1].in_features == 8 * 4 + 6
    p_in = (t_(inputs["x"]), t_(inputs["t"]).long(), t_(inputs["cond_frames"]))
    cond = t_(inputs["cond"])
    some = np.array([False, True, False])
    with torch.no_grad():
        got = unet(*p_in, cond=cond)
        got_mask = unet(*p_in, cond=cond, null_cond_mask=t_(some))
        got_null = unet(*p_in)
    close(got, japply(params, *j_in, jnp.zeros((3,), bool)), 2e-4)
    close(got_mask, japply(params, *j_in, jnp.asarray(some)), 2e-4)
    close(got_null, japply(params, *j_in, jnp.ones((3,), bool)), 2e-4)
    assert got.abs().max() <= 1.0  # use_final_activation
    close(got_null[1], got_mask[1], 1e-6)  # the masked sample takes the null embedding


@pytest.mark.parametrize("scale", [0.0, 1.0, 2.0])
def test_guided_denoise_fn_matches_jax(guided, scale):
    params, inputs, j_in, japply, unet = guided
    x, t, c, cond = j_in

    def j_denoise(x, t, c, f, null_cond_mask=None):
        mask = jnp.zeros((3,), bool) if null_cond_mask is None else null_cond_mask
        return japply(params, x, t, c, cond, mask)

    def p_denoise(x, t, c, f, **kw):
        return unet(x, t, c, f, cond=t_(inputs["cond"]), **kw)

    want = j_diff.guided_denoise_fn(j_denoise, scale)(x, t, c, None)
    with torch.no_grad():
        got = diffusion.guided_denoise_fn(p_denoise, scale)(
            t_(inputs["x"]), t_(inputs["t"]).long(), t_(inputs["cond_frames"]), None)
    close(got, want, 2e-4)


# ------------------------------------------------- sample_video and decode
CFG = dict(cond_frames=2, pred_frames=2, frame_shape=32, timesteps=1000, sampling_timesteps=2,
           ddim_eta=0.0, dim=16, dim_mults=(1,), attn_heads=2, attn_dim_head=8)


def test_sample_video_and_latent_sampler_match_jax():
    jfd = JFlowDiffusion(JConfig(flow_params=tiny_flow_params(), remat=False, **CFG))
    shapes = jax.eval_shape(jfd.init_variables, jax.random.PRNGKey(0))
    lfae_vars = random_variables(dict(shapes[0]), 1)
    unet_vars = {"params": random_variables(dict(shapes[1]["params"]), 2)}
    cond = np.random.default_rng(4).uniform(size=(2, 2, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(6)

    def sample(lv, uv, key, cond):
        return jfd.sample_video(lv, uv, key, cond)

    args = (lfae_vars, unet_vars, key, jnp.asarray(cond))
    want = fast_jit(sample, *args)(*args)
    x_t = np.array(jax.random.normal(jax.random.split(key)[1], (2, 2, 16, 16, 3), jnp.float32))

    fd = FlowDiffusion(FlowDiffusionConfig(flow_params=tiny_flow_params(), **CFG), device="cpu")
    fd.lfae.load_state_dict(convert.lfae_state_dict(lfae_vars))
    fd.unet.load_state_dict(convert.unet_state_dict(unet_vars["params"]))
    got = fd.sample_video(None, t_(cond), init_noise=t_(x_t))
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k], want[k], 1e-3)
    latent = fd.make_sampler(decode=False)(None, t_(cond), init_noise=t_(x_t))
    assert sorted(latent) == ["real_vid_conf", "real_vid_grid", "sample_vid_conf",
                              "sample_vid_grid"]
    for k, v in latent.items():
        assert torch.equal(v, got[k]), k
    drawn = fd.sample_video(torch.Generator().manual_seed(0), t_(cond), decode=False)
    assert "sample_out_vid" not in drawn and torch.isfinite(drawn["sample_vid_grid"]).all()


# ------------------------------------------------------------- Fourier
@pytest.mark.parametrize("seed,freqs", [(0, 10), (3, 4)])
def test_fourier_encoding_matches_jax(seed, freqs):
    x = np.random.default_rng(5).normal(size=(2, 3, 4, 5, 8)).astype(np.float32)
    jm = JFourier(num_frequencies=freqs, seed=seed)
    params = random_variables(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)["params"], 2)
    want = jm.apply({"params": params}, jnp.asarray(x))
    m = FourierEncoding3D(8, num_frequencies=freqs, seed=seed)
    m.load_state_dict({"proj.weight": t_(np.asarray(params["proj"]["kernel"]).T.copy())})
    with torch.no_grad():
        close(m(t_(x)), want, 1e-5)


# ------------------------------------------------------------------- F5
@pytest.mark.parametrize("loss_type", ["l1", "l2"])
def test_config_takes_the_yaml_loss_type(tmp_path, loss_type):
    raw = yaml.safe_load(open("configs/DM/kth.yaml"))
    raw["diffusion_params"]["model_params"]["loss_type"] = loss_type
    port = config.dm_config_from_yaml(raw)
    ref = j_config.dm_config_from_yaml(raw)
    assert port.loss_type == ref.loss_type == loss_type
    assert port.make_diffusion().loss_type == loss_type
    assert dataclasses.asdict(port)["loss_type"] == dataclasses.asdict(ref)["loss_type"]
