"""The port's data-parallel AE step (AETrainer with a data group: SyncBN,
the losses averaged inside the loss, the gradients averaged) at world 2
against JAX's AE shard_map step on 2 CPU devices, and against the port's
single-process step on the global batch, on the CPU, float32.

The tiny model of tests/test_parallel.py:295-337 (32 px, scales 1 and
0.5). The port runs as a 2-rank gloo group in spawned processes
(``torch_parallel_ranks``), fed each shard's TPS draw, which is read back
from inside the JAX step with its shard index. Losses to 1e-4 relative,
parameters within 2.2 learning rates (Adam's first update, as
tests/test_torch_ae.py), running statistics to 1e-5 of max(1, their max);
the averaged gradients within the single-process step's rounding spread
(``AE_ROUGH_MULT``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from extdm_tpu.models.lfae import recon_model as j_recon
from extdm_tpu.parallel.mesh import make_mesh
from extdm_tpu.train import ae_trainer as j_ae
from extdm_tpu_torch import convert
from extdm_tpu_torch.models.lfae.transform import TPSTransform
from test_torch_parallel import GAMMA, LR, MILESTONES, WORLD, as_np, fast
from torch_port_helpers import random_variables

t_ = torch.from_numpy
AE_BATCH = 8
# tests/test_parallel.py:297-316
AE_KW = dict(
    region_predictor_cfg=dict(block_expansion=8, max_features=32, num_blocks=2, scale_factor=0.5,
                              pad=0),
    bg_predictor_cfg=dict(block_expansion=8, max_features=32, num_blocks=2, bg_type="affine"),
    generator_cfg=dict(block_expansion=8, max_features=32, num_down_blocks=2,
                       num_bottleneck_blocks=1, skips=True,
                       pixelwise_flow_predictor_params=dict(
                           block_expansion=8, max_features=32, num_blocks=2, scale_factor=0.5,
                           use_deformed_source=True, use_covar_heatmap=True,
                           estimate_occlusion_map=True)),
    num_regions=3, loss_weights=dict(perceptual=[1, 1, 1, 1, 1], equivariance_shift=10,
                                     equivariance_affine=10, reconstruction=1),
    transform_params=dict(sigma_affine=0.05, sigma_tps=0.005, points_tps=5), scales=(1.0, 0.5))


def jax_ae(mesh):
    """JAX's AE shard_map step (SyncBN) and the port's inputs: the converted
    variables, the global batch and every shard's TPS draw in shard order."""
    jm = j_recon.ReconstructionModel(**AE_KW)
    rs = np.random.RandomState(0)
    batch = {k: rs.rand(AE_BATCH, 32, 32, 3).astype(np.float32) for k in ("source", "driving")}
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "tps": jax.random.PRNGKey(1)},
        {k: jnp.asarray(v[:2]) for k, v in batch.items()}))
    variables = random_variables(dict(shapes), 47)
    variables["params"]["vgg"] = jax.tree_util.tree_map(
        lambda a: a * np.float32(np.sqrt(6.0)) if a.ndim == 4 else a, variables["params"]["vgg"])
    trainer = j_ae.AETrainer(jm, j_ae.make_optimizer(LR, list(MILESTONES), GAMMA))
    state = trainer.init_state(variables)
    draws = {}
    real_random_tps = j_recon.random_tps

    def recording_random_tps(key, n, **params):
        t = real_random_tps(key, n, **params)
        jax.debug.callback(lambda i, *a: draws.__setitem__(int(i), [np.array(v) for v in a]),
                           jax.lax.axis_index("data"), t.theta, t.control_points,
                           t.control_params)
        return t

    key = jax.random.PRNGKey(48)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_recon, "random_tps", recording_random_tps)
        step = trainer.shard_mapped_train_step(mesh, donate=False)
        args = (state, key, {k: jnp.asarray(v) for k, v in batch.items()})
        new_state, aux = fast(step, *args)(*args)
        jax.block_until_ready(new_state)
    assert sorted(draws) == list(range(WORLD))
    tps = (t_(np.concatenate([draws[i][0] for i in range(WORLD)])), t_(draws[0][1]),
           t_(np.concatenate([draws[i][2] for i in range(WORLD)])))
    inp = {"kwargs": AE_KW, "state": convert.recon_state_dict(variables),
           "batch": {k: t_(v) for k, v in batch.items()}, "tps": tps,
           "opt": (LR, list(MILESTONES), GAMMA)}
    want = {"aux": {k: float(v) for k, v in aux.items()},
            "state": convert.recon_state_dict({"params": as_np(new_state.params),
                                               "batch_stats": as_np(new_state.batch_stats)})}
    return inp, want


@pytest.fixture(scope="module")
def runs(devices, tmp_path_factory):
    """JAX's step, the port's single-process step on the global batch (and
    on the batch moved by one ulp), then the 2 ranks' step."""
    ae_inp, ae_want = jax_ae(make_mesh(model=1, devices=devices[:WORLD]))
    single = {}
    for name, batch in (("ae", ae_inp["batch"]),
                        ("ae_ulp", {k: torch.nextafter(v, torch.full_like(v, 2.0))
                                    for k, v in ae_inp["batch"].items()})):
        single_ae = ranks.ae_trainer(ae_inp)
        aux = single_ae.train_step(None, batch, tps=TPSTransform(*ae_inp["tps"]))
        single[name] = {"aux": {k: v.item() for k, v in aux.items()},
                        "state": single_ae.model.state_dict(),
                        "grads": {n: p.grad for n, p in single_ae.model.named_parameters()}}
    got = ranks.run_cases({"ae": ae_inp}, tmp_path_factory.mktemp("parallel_ae"), WORLD)
    return dict(got=got, single=single, ae=ae_want)


def _ae_close(got, want):
    for k, v in want["aux"].items():
        np.testing.assert_allclose(got["aux"][k], v, rtol=1e-4, err_msg=k)
    for name, ref in want["state"].items():
        if name.endswith("num_batches_tracked"):
            continue
        value, ref = got["state"][name].numpy(), ref.detach().numpy()
        if "running_" in name:
            np.testing.assert_allclose(value, ref, rtol=0,
                                       atol=1e-5 * max(1.0, np.abs(ref).max()), err_msg=name)
        else:  # Adam's first update: lr sign(g), whose sign is noise where g is near 0
            np.testing.assert_allclose(value, ref, rtol=0, atol=2.2 * LR, err_msg=name)


def test_ae_step_with_sync_bn_matches_jax_shard_map(runs):
    for g in runs["got"]:
        _ae_close(g["ae"], runs["ae"])


# The tiny random AE's loss is badly conditioned (tests/test_torch_ae.py:
# float32 gradients ~10% of a tensor's max from float64 ones), so its
# gradients move visibly under any change of rounding. Each averaged
# gradient of the world-2 step is held to the single-process one within
# AE_ROUGH_MULT times how far the single-process gradient moves when every
# input pixel moves by one float32 ulp, plus 1e-5 of the tensor's max. A
# gradient averaged wrongly (a sum, a rank's alone) is off by its own size.
AE_ROUGH_MULT = 4.0


def test_ae_step_at_world_2_equals_the_global_batch_step(runs):
    """Losses, parameters and running statistics as against JAX; the
    averaged gradients within the single-process step's rounding spread."""
    single, ulp = runs["single"]["ae"], runs["single"]["ae_ulp"]
    for g in runs["got"]:
        _ae_close(g["ae"], single)
        for name, ref in single["grads"].items():
            rough = (ulp["grads"][name] - ref).abs().max().item()
            tol = AE_ROUGH_MULT * rough + 1e-5 * ref.abs().max().item()
            np.testing.assert_allclose(g["ae"]["grads"][name].numpy(), ref.numpy(), rtol=0,
                                       atol=tol, err_msg=name)
    a, b = (g["ae"]["state"] for g in runs["got"])
    assert all(torch.equal(a[n], b[n]) for n in a)
