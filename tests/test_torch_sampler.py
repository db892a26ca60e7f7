"""The port's ``GaussianDiffusion.sample`` (DDIM or the ancestral
``p_sample_loop``) against the JAX package's, on the CPU, float32.

A small denoiser written in both frameworks stands in for the UNet. The
port is fed JAX's draws: x_T and the per-step normals of JAX's split-key
chain (``key, nkey = split(key)`` per step), replayed through ``init_noise``
and ``noises``. At as many sampling steps as the schedule (8 of 8) ``sample``
takes the ancestral loop; DDIM's last time pair there is (0, 0) and its
sigma 0/0, which gave NaN latents when the sampler always ran DDIM. At 8 of
7 steps DDIM still runs. Latents within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extdm_tpu.models.dm import diffusion as j_diff
from extdm_tpu_torch.models.dm import diffusion

SHAPE_COND, PRED = (2, 2, 4, 4, 3), 3


def _denoise_jax(x, t, cond, fea):
    return jnp.tanh(0.3 * x + 0.1 * cond.mean(axis=1, keepdims=True)) + 1e-3 * t[:, None, None,
                                                                              None, None]


def _denoise_torch(x, t, cond, fea):
    return (torch.tanh(0.3 * x + 0.1 * cond.mean(dim=1, keepdim=True))
            + 1e-3 * t[:, None, None, None, None].float())


def _jax_draws(key, shape, steps):
    """x_T and the per-step normals of the JAX samplers' key chain."""
    key, init_key = jax.random.split(key)
    init = jax.random.normal(init_key, shape, jnp.float32)
    noises = []
    for _ in range(steps):
        key, nkey = jax.random.split(key)
        noises.append(np.array(jax.random.normal(nkey, shape, jnp.float32)))
    return np.array(init), noises


@pytest.mark.parametrize("timesteps,sampling", [(8, 8), (8, 7)])
def test_sample_matches_jax_with_its_draws(timesteps, sampling):
    cond = np.random.default_rng(0).normal(size=SHAPE_COND).astype(np.float32)
    shape = (SHAPE_COND[0], PRED) + SHAPE_COND[2:]
    key = jax.random.PRNGKey(3)
    jd = j_diff.GaussianDiffusion(j_diff.DiffusionSchedule.create(timesteps),
                                  sampling_timesteps=sampling)
    want = np.asarray(jd.sample(_denoise_jax, key, jnp.asarray(cond), PRED, None))
    init, noises = _jax_draws(key, shape, min(sampling, timesteps))

    d = diffusion.GaussianDiffusion(diffusion.DiffusionSchedule.create(timesteps),
                                    sampling_timesteps=sampling)
    got = d.sample(_denoise_torch, None, torch.from_numpy(cond), PRED, None,
                   init_noise=torch.from_numpy(init),
                   noises=[torch.from_numpy(n) for n in noises]).numpy()
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_sample_dispatch_and_generator_draws():
    """``sample`` picks DDIM below the schedule's length and the ancestral
    loop at it; with a generator (no given draws) both give finite latents,
    the same for the same seed."""
    d = diffusion.GaussianDiffusion(diffusion.DiffusionSchedule.create(8), sampling_timesteps=8)
    cond = torch.from_numpy(np.random.default_rng(1).normal(size=SHAPE_COND).astype(np.float32))
    calls = []
    for steps in (8, 7):
        d = diffusion.GaussianDiffusion(d.schedule, sampling_timesteps=steps)
        counted = lambda *a, **k: calls.append(1) or _denoise_torch(*a, **k)  # noqa: E731
        outs = [d.sample(counted, torch.Generator().manual_seed(5), cond, PRED) for _ in range(2)]
        assert torch.isfinite(outs[0]).all()
        assert torch.equal(outs[0], outs[1])
    assert len(calls) == 2 * 8 + 2 * 7  # 8 ancestral steps, then 7 DDIM time pairs
