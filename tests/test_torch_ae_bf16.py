"""The AE step's bf16 compute policy (``ReconstructionModel(dtype=bfloat16)``,
the AE job's ``--bf16``) against the JAX package's
``ReconstructionModel(dtype=jnp.bfloat16)`` on the CPU, at the tiny size of
tests/test_torch_ae.py (its LFAE, losses and TPS settings; perceptual scale
1 only), one batch of two 32 px pairs and one TPS draw shared by both
packages, the same converted weights.

The policy, held in both packages: parameters, their gradients and the
BatchNorm statistics stay float32; each loss comes out in the same type in
both (the perceptual loss, a mean of bf16 VGG features, in bf16; the
others float32).

Tolerances, stated and measured. At this random tiny model the losses and
gradients are badly conditioned (see tests/test_torch_ae.py: train-mode
BatchNorm over near-dead channels, a temperature-0.1 region softmax), so
bf16 rounding moves them far: JAX's own bf16 losses lie up to 1.45% from
its float32 ones, and some of its bf16 gradients (the bg predictor's head)
differ from its float32 ones by more than their own max. Both packages
round to bf16 in the same places but sum in other orders, so:
- each loss within LOSS_REL_TOL = 2e-2 of JAX's bf16 loss (measured: at
  most 0.93%, equivariance_affine);
- each gradient within GRAD_SPREAD_MULT = 3 times the distance of JAX's
  bf16 gradient from the float32 one for that tensor, plus GRAD_FLOOR =
  1e-3 of its max (measured: at most 1.86 times that distance plus a third
  of the floor, generator.up_blocks.0.norm.bias). The float32 gradient is
  the port's (held against JAX's float32 AE step in tests/test_torch_ae.py),
  which saves a second JAX compile;
- each BatchNorm running statistic after the step the same way (measured:
  at most 2.05 times, generator.bottleneck.r0.norm1.running_mean).
A lost or doubled term, a missing cast or a float32 policy moves these by
far more in the losses' types or values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extdm_tpu.models.lfae import recon_model as j_recon
from extdm_tpu.models.lfae import transform as j_transform
from extdm_tpu_torch import convert
from extdm_tpu_torch.models.lfae import transform
from extdm_tpu_torch.models.lfae.recon_model import ReconstructionModel
from extdm_tpu_torch.train import ae_trainer, train_ae
from test_torch_ae import tiny_model_kwargs
from test_torch_jobs import fast_jit, loss_records, tiny_yaml
from torch_port_helpers import random_variables

t_ = torch.from_numpy
LOSS_REL_TOL = 2e-2
GRAD_SPREAD_MULT = 3.0
GRAD_FLOOR = 1e-3


def model_kwargs():
    return dict(tiny_model_kwargs(), scales=(1.0,))


@pytest.fixture(scope="module")
def runs():
    """Losses, gradients and updated BatchNorm statistics of one forward
    and backward: JAX in bf16, the port in bf16 and float32."""
    kw = model_kwargs()
    zeros = jnp.zeros((2, 32, 32, 3))
    jm16 = j_recon.ReconstructionModel(train=True, dtype=jnp.bfloat16, **kw)
    shapes = jax.eval_shape(lambda: jm16.init(
        {"params": jax.random.PRNGKey(0), "tps": jax.random.PRNGKey(1)},
        {"source": zeros, "driving": zeros}))
    variables = random_variables(dict(shapes), 7)
    variables["params"]["vgg"] = jax.tree_util.tree_map(  # He scale, as tests/test_torch_ae.py
        lambda a: a * np.float32(np.sqrt(6.0)) if a.ndim == 4 else a, variables["params"]["vgg"])
    rng = np.random.default_rng(8)
    batch = {k: rng.uniform(0.1, 0.9, size=(2, 32, 32, 3)).astype(np.float32)
             for k in ("source", "driving")}
    tps = j_transform.random_tps(jax.random.PRNGKey(5), 2, **kw["transform_params"])

    def program(params, stats, batch):
        def loss(p):
            (losses, _), mut = jm16.apply({"params": p, "batch_stats": stats}, batch,
                                          rngs={"tps": jax.random.PRNGKey(0)},
                                          mutable=["batch_stats"])
            return sum(losses.values()), (losses, mut["batch_stats"])
        (_, (losses, new_stats)), grads = jax.value_and_grad(loss, has_aux=True)(params)
        return losses, grads, new_stats

    args = (variables["params"], variables["batch_stats"],
            {k: jnp.asarray(v) for k, v in batch.items()})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_recon, "random_tps", lambda key, b, **params: tps)
        losses, grads, stats = fast_jit(program, *args)(*args)
    as_np = lambda tree: jax.tree_util.tree_map(lambda a: np.array(a), tree)  # noqa: E731
    jax_run = dict(losses=as_np(losses), grads=convert.recon_state_dict({"params": as_np(grads)}),
                   stats=convert.recon_state_dict({"batch_stats": as_np(stats)}),
                   raw=(grads, stats))

    port_tps = transform.TPSTransform(*(t_(np.array(a)) for a in
                                        (tps.theta, tps.control_points, tps.control_params)))
    port = {}
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        model = ReconstructionModel(dtype=dtype, **kw)
        model.load_state_dict(convert.recon_state_dict(variables))
        model.train()
        losses, _ = model(t_(batch["source"]), t_(batch["driving"]), port_tps)
        sum(losses.values()).backward()
        port[name] = dict(model=model, losses={k: v.detach() for k, v in losses.items()},
                          grads={n: p.grad for n, p in model.named_parameters()},
                          stats={k: v.clone() for k, v in model.state_dict().items()
                                 if "running" in k})
    return dict(jax=jax_run, port=port, model=port["bf16"]["model"],
                losses=port["bf16"]["losses"], variables=variables, batch=batch, tps=port_tps)


def test_policy_keeps_float32_parameters_and_statistics(runs):
    model = runs["model"]
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert {p.grad.dtype for p in model.parameters()} == {torch.float32}
    assert {b.dtype for n, b in model.named_buffers() if "running" in n} == {torch.float32}
    grads, stats = runs["jax"]["raw"]
    for tree in (grads, stats):
        assert {a.dtype for a in jax.tree_util.tree_leaves(tree)} == {jnp.dtype(jnp.float32)}
    # every conv computes in bf16: the VGG features, BatchNorm outputs and
    # conv outputs of a bf16 forward are bf16
    seen = set()
    hooks = [m.register_forward_hook(lambda m, a, out: seen.add(out.dtype))
             for m in model.modules() if type(m).__name__ in ("Conv2d", "BatchNorm")]
    with torch.no_grad(), train_ae.frozen_statistics(model):
        model(t_(runs["batch"]["source"]), t_(runs["batch"]["driving"]), runs["tps"])
    for h in hooks:
        h.remove()
    assert seen == {torch.bfloat16}


def test_losses_match_jax_bf16(runs):
    want, got = runs["jax"]["losses"], runs["losses"]
    assert sorted(got) == sorted(want)
    for k in want:
        assert str(got[k].dtype).replace("torch.", "") == str(want[k].dtype), k
        np.testing.assert_allclose(got[k].float().item(), float(want[k]), rtol=LOSS_REL_TOL,
                                   err_msg=k)


def _within_spread(got, want16, want32, what):
    for name, w16 in want16.items():
        w16 = w16.double()
        spread = (w16 - want32[name].double()).abs().max().item()
        tol = GRAD_SPREAD_MULT * spread + GRAD_FLOOR * w16.abs().max().item()
        np.testing.assert_allclose(got[name].double().numpy(), w16.numpy(), rtol=0, atol=tol,
                                   err_msg=f"{what} {name}")


def test_gradients_match_jax_bf16(runs):
    grads, j16 = runs["port"]["bf16"]["grads"], runs["jax"]["grads"]
    assert sorted(grads) == sorted(j16)
    _within_spread(grads, j16, runs["port"]["f32"]["grads"], "gradient")


def test_batchnorm_statistics_match_jax_bf16(runs):
    stats = runs["port"]["bf16"]["stats"]
    j16 = {k: v for k, v in runs["jax"]["stats"].items() if "running" in k}
    assert sorted(stats) == sorted(j16)
    assert all(v.dtype == torch.float32 for v in stats.values())
    _within_spread(stats, j16, runs["port"]["f32"]["stats"], "running statistic")


def test_trainer_steps_in_bf16_on_float32_master_weights(runs):
    kw = model_kwargs()
    model = ReconstructionModel(dtype=torch.bfloat16, **kw)
    model.load_state_dict(convert.recon_state_dict(runs["variables"]))
    trainer = ae_trainer.AETrainer(model, ae_trainer.make_optimizer(1e-4, (100,), 0.5),
                                   device="cpu")
    batch = {k: t_(v) for k, v in runs["batch"].items()}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    aux = trainer.train_step(None, batch, tps=runs["tps"])
    assert all(torch.isfinite(v).all() for v in aux.values())
    assert aux["perceptual"].dtype == torch.bfloat16 and aux["loss_total"].dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype == torch.float32 for n, b in model.named_buffers() if "running" in n)
    assert any(not torch.equal(p, before[n]) for n, p in model.named_parameters())
    with pytest.raises(ValueError, match="float32 master weights"):
        ae_trainer.AETrainer(ReconstructionModel(**kw).to(torch.bfloat16),
                             ae_trainer.make_optimizer(1e-4, (100,), 0.5), device="cpu")


def test_ae_job_trains_with_bf16(tmp_path):
    cfg_path, _ = tiny_yaml(tmp_path)
    log = str(tmp_path / "ae")
    assert train_ae.main(["--config", cfg_path, "--device", "cpu", "--synthetic_videos", "3",
                          "--batch_size", "2", "--max_steps", "2", "--valid_every", "0",
                          "--bf16", "--device_augment", "--log_dir", log]) == 0
    recs = loss_records(log, "loss_total")
    assert [r["step"] for r in recs] == [0, 1]
    assert all(np.isfinite(r["loss_total"]) for r in recs)
