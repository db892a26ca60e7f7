"""Port stage-1 (LFAE) training against the JAX package on the CPU, float32.

Sizes: the tiny LFAE of torch_port_helpers.TINY_FLOW_PARAMS with the loss
and transform settings of tests/test_device_augment.py, 32 px frames,
perceptual scales (1, 0.5). The JAX side runs under ``jax.jit``.

- Train-mode BatchNorm against flax ``mutable=["batch_stats"]`` (output and
  running statistics, two updates in a row), 1e-5.
- ``warp_coordinates``, ``transform_frame``, ``jacobian`` and the gradient
  through ``jacobian`` against the JAX transform, 1e-5 of max(1, max|ref|).
- VGG19 features against ``Vgg19Features``, 1e-5 of each feature's max.
- ``augment_pairs`` fed the JAX draws (the key splits of JAX
  ``augment_pairs``, replayed here), 1e-5; this JAX side runs eagerly.
- Three ``AETrainer.train_step``s against JAX's, both in float32 (Adam,
  learnable loss weights, KTH flip + jitter augmentation, nan guard 1), the
  port fed JAX's augmentation and TPS draws: the step-1 losses to 1e-5
  relative; every step-1 gradient against the JAX package's float64
  gradients (the bound is explained in that test); params, loss weights and
  batch_stats after step 1, and after a step 2 that the port takes from
  JAX's step-1 state (``load_jax_state``); a third, non-finite step skipped
  by both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extdm_tpu.models.lfae import recon_model as j_recon
from extdm_tpu.models.lfae import transform as j_transform
from extdm_tpu.models.lfae.vgg import Vgg19Features as JVgg
from extdm_tpu.nn.layers import BatchNorm as JBatchNorm
from extdm_tpu.train import ae_trainer as j_trainer
from extdm_tpu.train import device_augment as j_aug
from extdm_tpu_torch import convert
from extdm_tpu_torch.config import KTH_AE_YAML, kth_ae_training_config
from extdm_tpu_torch.models.lfae import transform
from extdm_tpu_torch.models.lfae.recon_model import ReconstructionModel
from extdm_tpu_torch.models.lfae.vgg import Vgg19Features
from extdm_tpu_torch.nn.layers import BatchNorm
from extdm_tpu_torch.train import ae_trainer, device_augment
from torch_port_helpers import close, random_variables, tiny_flow_params

t_ = torch.from_numpy


def close_to_max(a, b, rel, name=""):
    """max|a - b| <= rel * max(1, max|b|)."""
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=rel * max(1.0, np.abs(b).max()),
                               err_msg=name)


# ---------------------------------------------------------------- BatchNorm
def test_train_mode_batchnorm_matches_flax():
    rng = np.random.default_rng(0)
    C = 6
    variables = {"params": {"bn": {"scale": 1 + 0.1 * rng.normal(size=C).astype(np.float32),
                                   "bias": 0.1 * rng.normal(size=C).astype(np.float32)}},
                 "batch_stats": {"bn": {"mean": 0.1 * rng.normal(size=C).astype(np.float32),
                                        "var": rng.uniform(0.5, 1.5, C).astype(np.float32)}}}
    xs = [(2.0 + 1.5 * rng.normal(size=(3, 5, 4, C))).astype(np.float32) for _ in range(2)]
    jbn = JBatchNorm(use_running_average=False)
    apply = jax.jit(lambda v, x: jbn.apply(v, x, mutable=["batch_stats"]))
    port = BatchNorm(C).train()
    port.load_state_dict({k[len("bn."):]: v for k, v in convert.lfae_state_dict(variables).items()})
    for x in xs:  # two updates in a row: the second starts from the first's statistics
        want, mutated = apply(variables, jnp.asarray(x))
        variables = {"params": variables["params"], "batch_stats": mutated["batch_stats"]}
        close(port(t_(x)).detach(), want, 1e-5)
        close(port.running_mean, variables["batch_stats"]["bn"]["mean"], 1e-5)
        close(port.running_var, variables["batch_stats"]["bn"]["var"], 1e-5)
    # eval mode normalizes with the running statistics and leaves them alone
    port.eval()
    before = port.running_var.clone()
    want = JBatchNorm(use_running_average=True).apply(variables, jnp.asarray(xs[0]))
    close(port(t_(xs[0])).detach(), want, 1e-5)
    assert torch.equal(port.running_var, before)


# ---------------------------------------------------------------- transform
def _tps_pair(rng, B):
    theta = (np.eye(2, 3)[None] + 0.05 * rng.normal(size=(B, 2, 3))).astype(np.float32)
    cp = np.asarray(j_transform.make_coordinate_grid(5, 5)).reshape(-1, 2)
    params = (0.05 * rng.normal(size=(B, 1, 25))).astype(np.float32)
    return (j_transform.TPSTransform(jnp.asarray(theta), jnp.asarray(cp), jnp.asarray(params)),
            transform.TPSTransform(t_(theta), t_(cp.copy()), t_(params)))


def test_tps_warp_frame_and_jacobian_match_jax():
    rng = np.random.default_rng(1)
    jt, pt = _tps_pair(rng, 2)
    coords = rng.uniform(-0.9, 0.9, size=(2, 7, 2)).astype(np.float32)
    close_to_max(transform.warp_coordinates(pt, t_(coords)),
                 j_transform.warp_coordinates(jt, jnp.asarray(coords)), 1e-5)
    close_to_max(transform.jacobian(pt, t_(coords)),
                 j_transform.jacobian(jt, jnp.asarray(coords)), 1e-5)
    frame = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    close_to_max(transform.transform_frame(pt, t_(frame)),
                 j_transform.transform_frame(jt, jnp.asarray(frame)), 1e-5)
    # the equivariance-affine loss backpropagates through the jacobian
    w = rng.normal(size=(2, 7, 2, 2)).astype(np.float32)
    want = jax.grad(lambda c: (j_transform.jacobian(jt, c) * w).sum())(jnp.asarray(coords))
    c = t_(coords).requires_grad_(True)
    (transform.jacobian(pt, c) * t_(w)).sum().backward()
    close_to_max(c.grad, want, 1e-5)


def test_random_tps_shapes_and_scale():
    g = torch.Generator().manual_seed(0)
    t = transform.random_tps(g, 4, sigma_affine=0.05, sigma_tps=0.005, points_tps=5)
    assert t.theta.shape == (4, 2, 3) and t.control_points.shape == (25, 2)
    assert t.control_params.shape == (4, 1, 25)
    assert (t.theta - torch.eye(2, 3)).abs().max() < 0.05 * 6
    assert transform.random_tps(g, 2, sigma_affine=0.05).control_points is None


# ---------------------------------------------------------------------- VGG
def test_vgg19_features_match_jax():
    jv = JVgg()
    x = np.random.default_rng(2).uniform(size=(2, 32, 32, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jv.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    variables = random_variables(dict(shapes), 3)
    want = jax.jit(jv.apply)(variables, jnp.asarray(x))
    port = Vgg19Features()
    sd = convert.recon_state_dict({"params": {"vgg": variables["params"]}})
    port.load_state_dict({k[len("vgg."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = port(t_(x))
    assert [tuple(f.shape) for f in got] == [f.shape for f in want]
    for i, (a, b) in enumerate(zip(got, want)):
        close_to_max(a, b, 1e-5, f"relu{i + 1}_1")


# -------------------------------------------------------------- augmentation
FLIP_JITTER = {"flip_param": {"horizontal_flip": True, "time_flip": True},
               "jitter_param": {"brightness": 0.1, "contrast": 0.1, "saturation": 0.1,
                                "hue": 0.1}}


def jax_augment_draws(key, B, in_hw, flip_param=None, jitter_param=None, resize_param=None,
                      rotation_param=None, crop_param=None):
    """The per-pair parameters JAX ``augment_pairs`` draws from `key`, in the
    port's ``sample_augment`` layout."""
    ks = jax.random.split(key, 8)
    fp, jp = flip_param or {}, jitter_param or {}
    tmask = jax.random.bernoulli(ks[0], 0.5, (B,)) if fp.get("time_flip") else None
    hmask = jax.random.bernoulli(ks[1], 0.5, (B,))
    if tmask is not None:
        hmask = jnp.logical_and(~tmask, hmask)
    as_t = lambda a: None if a is None else torch.from_numpy(np.array(a))  # noqa: E731
    params = {"time": as_t(tmask), "hflip": as_t(hmask) if fp.get("horizontal_flip") else None,
              "geometry": None}
    if resize_param or rotation_param or crop_param:
        size = int((crop_param or {}).get("size", in_hw[0]))
        geo = j_aug.sample_geometry(ks[7], B, in_hw, size, resize_param=resize_param,
                                    rotation_param=rotation_param, crop_param=crop_param)
        params["geometry"] = (size, *map(as_t, geo))
    for name, k in (("brightness", ks[2]), ("saturation", ks[3]), ("contrast", ks[4])):
        a = jp.get(name, 0.0)
        params[name] = as_t(jax.random.uniform(k, (B, 1, 1, 1), minval=max(0.0, 1.0 - a),
                                               maxval=1.0 + a)) if a else None
    hue = jp.get("hue", 0.0)
    params["hue"] = as_t(jax.random.uniform(ks[5], (B, 1, 1), minval=-hue,
                                            maxval=hue)) if hue else None
    return params


@pytest.mark.parametrize("config", [
    FLIP_JITTER,
    {"flip_param": {"horizontal_flip": True}, "rotation_param": {"degrees": 10},
     "resize_param": {"ratio": (0.9, 1.1)}, "crop_param": {"size": 24},
     "jitter_param": {"brightness": 0.1, "hue": 0.1}},
], ids=["flip_jitter", "geometry"])
def test_augment_pairs_with_jax_draws(config):
    rng = np.random.default_rng(4)
    src = rng.integers(0, 256, size=(16, 32, 32), dtype=np.uint8)
    drv = rng.integers(0, 256, size=(16, 32, 32, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(5)
    # eager: under jax.jit, XLA's CPU build of the geometry + hue chain gives
    # RGB frames up to 0.9 away from JAX's own eager result at this seed; the
    # port agrees with the eager one
    want = j_aug.augment_pairs(jnp.asarray(src), jnp.asarray(drv), key, **config)
    params = jax_augment_draws(key, 16, (32, 32), **config)
    got = device_augment.augment_pairs(t_(src), t_(drv), params)
    for a, b in zip(got, want):
        close(a, b, 1e-5)
    draw = device_augment.sample_augment(torch.Generator().manual_seed(0), 16, (32, 32),
                                         **config)
    assert {k: v is None for k, v in draw.items()} == {k: v is None for k, v in params.items()}


def test_canonicalize_and_prepare_batch():
    rng = np.random.default_rng(6)
    for x in (rng.integers(0, 256, size=(2, 4, 4), dtype=np.uint8),
              rng.integers(0, 256, size=(2, 4, 4, 1), dtype=np.uint8),
              rng.uniform(size=(2, 4, 4, 3)).astype(np.float32)):
        close(device_augment.canonicalize_images(t_(x)), j_aug.canonicalize_images(jnp.asarray(x)),
              0)
    s, d = device_augment.prepare_batch(t_(x), t_(x), None)
    assert torch.equal(s, t_(x)) and torch.equal(d, t_(x))


# ------------------------------------------------------------------ trainer
def tiny_model_kwargs():
    fp = tiny_flow_params()
    return dict(
        region_predictor_cfg=dict(fp["region_predictor_params"], estimate_affine=True),
        bg_predictor_cfg=fp["bg_predictor_params"],
        generator_cfg=dict(fp["generator_params"], revert_axis_swap=True),
        num_regions=3, num_channels=3, scales=(1.0, 0.5),
        loss_weights=dict(perceptual=[1, 1, 1, 1, 1], equivariance_shift=10,
                          equivariance_affine=10, reconstruction=10),
        transform_params=dict(sigma_affine=0.05, sigma_tps=0.005, points_tps=5))


LR, MILESTONES, GAMMA = 1e-4, (1,), 0.5


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


@pytest.fixture(scope="module")
def ae_runs():
    """Three train steps of each package in float32 from the same weights and
    batches (the third batch holds a NaN), the port fed JAX's augmentation
    and TPS draws; and the JAX package's step-1 gradients in float64 on the
    port's augmented step-1 batch. Returns what both recorded."""
    kw = tiny_model_kwargs()
    jm = j_recon.ReconstructionModel(train=True, **kw)
    zeros = jnp.zeros((2, 32, 32, 3))
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "tps": jax.random.PRNGKey(1)},
        {"source": zeros, "driving": zeros}))
    variables = random_variables(dict(shapes), 7)
    # He scale for the VGG kernels (the port's own VGG init), so that its
    # features keep their size through 13 layers instead of fading to where
    # the L1 loss's sign is float noise
    variables["params"]["vgg"] = jax.tree_util.tree_map(
        lambda a: a * np.float32(np.sqrt(6.0)) if a.ndim == 4 else a, variables["params"]["vgg"])
    # pixels in [0.1, 0.9], so that the jitter never clips one to exactly 0
    # or 1: saturated patches tie in VGG's max-pools, where the gradient's
    # route then hangs on the last bit of the augmentation's arithmetic
    rng = np.random.default_rng(8)
    batches = [{k: rng.uniform(0.1, 0.9, size=(2, 32, 32, 3)).astype(np.float32)
                for k in ("source", "driving")} for _ in range(3)]
    batches[2]["driving"][1, 3, 4, 0] = np.nan
    keys = [jax.random.PRNGKey(30 + i) for i in range(3)]

    draws = []  # JAX's TPS draws, read back from inside the jitted step
    real_random_tps = j_recon.random_tps

    def recording_random_tps(key, batch, **params):
        t = real_random_tps(key, batch, **params)
        jax.debug.callback(lambda *a: draws.append([np.array(v) for v in a]),
                           t.theta, t.control_points, t.control_params)
        return t

    trainer = j_trainer.AETrainer(jm, j_trainer.make_optimizer(LR, MILESTONES, GAMMA, nan_guard=1),
                                  learnable_loss_weights=True, device_augment=FLIP_JITTER)
    state = trainer.init_state(variables)
    jax_states, jax_aux = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_recon, "random_tps", recording_random_tps)
        step = jax.jit(trainer.train_step)
        for key, batch in zip(keys, batches):
            state, aux = step(state, key, {k: jnp.asarray(v) for k, v in batch.items()})
            jax.block_until_ready(state)
            jax_states.append(state)
            jax_aux.append({k: float(v) for k, v in aux.items()})
    assert len(draws) == 3

    model = ReconstructionModel(**kw)
    model.load_state_dict(convert.recon_state_dict(variables))
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    port = ae_trainer.AETrainer(model, ae_trainer.make_optimizer(LR, MILESTONES, GAMMA, nan_guard=1),
                                learnable_loss_weights=True, device_augment=FLIP_JITTER,
                                device="cpu")
    port_aux, port_states, grads, inputs = [], [], None, []
    for i, (key, batch, (theta, cp, cparams)) in enumerate(zip(keys, batches, draws)):
        if i == 1:  # step 2 starts from JAX's step-1 state: test_ae_train_steps_match_jax
            load_jax_state(port, jax_states[0])
        augment = jax_augment_draws(jax.random.split(key)[0], 2, (32, 32), **FLIP_JITTER)
        tps = transform.TPSTransform(t_(theta), t_(cp), t_(cparams))
        inputs.append((device_augment.prepare_batch(t_(batch["source"]), t_(batch["driving"]),
                                                    augment), tps))
        aux = port.train_step(None, {k: t_(v) for k, v in batch.items()}, tps=tps,
                              augment=augment)
        port_aux.append({k: float(v) for k, v in aux.items()})
        if grads is None:
            grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
            grads.update({f"lw.{k}": w.grad.clone() for k, w in port.loss_weights.items()})
        port_states.append(({n: v.detach().clone() for n, v in model.state_dict().items()},
                            {k: w.item() for k, w in port.loss_weights.items()}))

    (src, drv), tps = inputs[0]
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        tps64 = j_transform.TPSTransform(*_f64([t.numpy() for t in tps]))
        mp.setattr(j_recon, "random_tps", lambda key, batch, **params: tps64)
        v64 = _f64(variables)

        def loss_sum(params):
            (losses, _), _ = jm.apply({"params": params, "batch_stats": v64["batch_stats"]},
                                      {"source": src64, "driving": drv64},
                                      rngs={"tps": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
            return sum(losses.values())

        src64, drv64 = _f64(src.numpy()), _f64(drv.numpy())
        g64 = jax.jit(jax.grad(loss_sum))(v64["params"])
        grads64 = convert.recon_state_dict({"params": jax.tree_util.tree_map(np.asarray, g64)})
    return dict(model=model, port=port, init=init, jax_states=jax_states, jax_aux=jax_aux,
                port_aux=port_aux, port_states=port_states, grads=grads, grads64=grads64)


def load_jax_state(port, jstate):
    """Put a JAX AETrainState into the port's trainer: parameters, BatchNorm
    running statistics, loss weights and Adam's moments (optax's mu and nu)."""
    model = port.model
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    model.load_state_dict(convert.recon_state_dict(
        {"params": as_np(jstate.params), "batch_stats": as_np(jstate.batch_stats)}))
    adam = jstate.opt_state.inner_state[0]
    (mu, mu_lw), (nu, nu_lw) = adam.mu, adam.nu
    mu, nu = (convert.recon_state_dict({"params": as_np(t)}) for t in (mu, nu))
    opt = port.optimizer.opt
    with torch.no_grad():
        for name, p in model.named_parameters():
            opt.state[p]["exp_avg"].copy_(mu[name])
            opt.state[p]["exp_avg_sq"].copy_(nu[name])
        for k, w in port.loss_weights.items():
            w.fill_(float(jstate.loss_weights[k]))
            opt.state[w]["exp_avg"].fill_(float(mu_lw[k]))
            opt.state[w]["exp_avg_sq"].fill_(float(nu_lw[k]))
    assert all(int(opt.state[p]["step"]) == int(adam.count) for p in port.optimizer.params)


def zero_in_exact_arithmetic(name):
    """A conv bias in front of a BatchNorm, or the region logits' bias in
    front of their spatial softmax: its gradient is 0 in exact arithmetic,
    so what either package computes there is float noise."""
    return (name.endswith(".conv.bias") or name == "region_predictor.regions.bias"
            or (".bottleneck." in name and name.endswith(".conv1.bias")))


def _jax_grads(ae_runs):
    """Step 1's float32 gradients from optax's first moment, mu = (1 - b1) g."""
    mu_params, mu_lw = ae_runs["jax_states"][0].opt_state.inner_state[0].mu
    want = convert.recon_state_dict({"params": jax.tree_util.tree_map(lambda m: 2 * m, mu_params)})
    want.update({f"lw.{k}": torch.tensor(2 * float(v)) for k, v in mu_lw.items()})
    return want


def test_recon_losses_match_jax(ae_runs):
    want, got = ae_runs["jax_aux"][0], ae_runs["port_aux"][0]
    assert sorted(got) == sorted(want) == sorted(list(ae_trainer.LOSS_KEYS) + ["loss_total"])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_recon_gradients_match_jax(ae_runs):
    """Every gradient of step 1 (learnable loss weights at 1, so the model's
    gradients are those of the unweighted loss sum) against the JAX
    package's float64 gradients on the same batch and TPS draw.

    At this random tiny model the loss is badly conditioned (temperature-0.1
    region softmax, square roots and inverses of small region covariances):
    JAX's own float32 gradients lie up to ~10% of a tensor's max away from
    its float64 ones. So each port gradient must lie within 2e-4 of the
    tensor's max plus twice the distance of JAX's float32 gradient: the port
    in float32 is at least half as close to the reference as the reference
    itself in float32. Gradients that are 0 in exact arithmetic
    (``zero_in_exact_arithmetic``) are held to 1e-5 of the largest gradient
    in both packages. The learnable loss weights' gradients (the loss
    values) are held to 1e-5."""
    ref, f32, got = ae_runs["grads64"], _jax_grads(ae_runs), ae_runs["grads"]
    names = [n for n, _ in ae_runs["model"].named_parameters()]
    assert sorted(got) == sorted(f32) == sorted(names + [f"lw.{k}" for k in ae_trainer.LOSS_KEYS])
    assert sorted(ref) == sorted(names)
    largest = max(float(w.abs().max()) for w in ref.values())
    for name in names:
        w = ref[name].double()
        if zero_in_exact_arithmetic(name):
            assert max(got[name].abs().max().item(), w.abs().max().item()) <= 1e-5 * largest, name
            continue
        noise = (f32[name].double() - w).abs().max().item()
        tol = 2e-4 * w.abs().max().item() + 2 * noise
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0, atol=tol, err_msg=name)
    for k in ae_trainer.LOSS_KEYS:
        np.testing.assert_allclose(got[f"lw.{k}"].item(), f32[f"lw.{k}"].item(), rtol=1e-5)


def _jax_stats(state):
    return convert.recon_state_dict({"batch_stats": state.batch_stats})


def test_ae_train_steps_match_jax(ae_runs):
    """Params, loss weights and batch_stats after step 1, and after a step 2
    that both packages take from JAX's step-1 state. Adam's first update is
    -lr g / (|g| + eps): where |g| is clear of the float32 gradients' error
    (5% of the tensor's max; see the gradient test), both packages move an
    element by the same lr; elsewhere its sign is noise, so after step 1 an
    element may be 2 lr apart. Carried into step 2, those elements alone
    moved a BatchNorm running mean past its 1e-4 bound (1.1e-4 on
    bg_predictor.encoder.down_blocks.1, where train-mode BatchNorm amplifies
    them), so step 2 starts from one state. With b1 = 0.5 one update is at
    most 1.054 lr, so after one step two elements may be 2.2 lr apart."""
    want_g = ae_runs["grads64"]
    for i, stats_tol in ((0, 1e-5), (1, 1e-4)):
        sd, lw = ae_runs["port_states"][i]
        jstate = ae_runs["jax_states"][i]
        for name, want in convert.recon_state_dict({"params": jstate.params}).items():
            got, want = sd[name].numpy(), want.numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=2.2 * LR, err_msg=name)
            if i == 0 and not zero_in_exact_arithmetic(name):
                g, p0 = want_g[name].numpy(), ae_runs["init"][name].numpy()
                clear = np.abs(g) > 0.05 * np.abs(g).max()
                np.testing.assert_allclose((got - p0)[clear], (want - p0)[clear], rtol=0,
                                           atol=1e-3 * LR, err_msg=name)
        for k, v in jstate.loss_weights.items():
            np.testing.assert_allclose(lw[k], float(v), rtol=0, atol=1e-6, err_msg=k)
        for name, want in _jax_stats(jstate).items():
            if name.endswith("num_batches_tracked"):
                continue
            np.testing.assert_allclose(sd[name].numpy(), want.numpy(), rtol=0,
                                       atol=stats_tol * max(1.0, want.abs().max().item()),
                                       err_msg=f"step {i + 1} {name}")


def test_ae_nan_guard_skips_like_optax(ae_runs):
    """Step 3's batch holds a NaN: both packages skip the update (params and
    loss weights stay at step 2's) and count one non-finite step."""
    port, jstates = ae_runs["port"], ae_runs["jax_states"]
    assert not np.isfinite(ae_runs["port_aux"][2]["loss_total"])
    assert not np.isfinite(ae_runs["jax_aux"][2]["loss_total"])
    assert port.optimizer.notfinite_count == 1 == int(jstates[2].opt_state.notfinite_count)
    assert port.optimizer.count == 2
    (sd2, lw2), (sd3, lw3) = ae_runs["port_states"][1:]
    for name, _ in ae_runs["model"].named_parameters():
        assert torch.equal(sd3[name], sd2[name]), name
    assert lw3 == lw2
    jp2, jp3 = (convert.recon_state_dict({"params": s.params}) for s in jstates[1:])
    for name in jp3:
        assert torch.equal(jp3[name], jp2[name]), name


def test_ae_optimizer_steps_match_optax():
    """Adam(0.5, 0.999) with MultiStepLR against optax, two steps, 1e-6."""
    rng = np.random.default_rng(9)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    tx = j_trainer.make_optimizer(1e-2, (1,), 0.5)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    pp = {k: torch.nn.Parameter(t_(v.copy())) for k, v in params.items()}
    opt = ae_trainer.make_optimizer(1e-2, (1,), 0.5)(pp.values())
    for _ in range(2):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, updates)
        for k, p in pp.items():
            p.grad = t_(grads[k])
        opt.step()
        for k in params:
            close(pp[k].detach(), jp[k], 1e-6)


def test_perceptual_scale_under_16px_raises():
    kw = tiny_model_kwargs()
    kw["scales"] = (1.0, 0.25)  # 32 px frames -> an 8 px VGG input
    model = ReconstructionModel(**kw)
    x = torch.rand(1, 32, 32, 3)
    tps = transform.random_tps(torch.Generator().manual_seed(0), 1, **kw["transform_params"])
    with pytest.raises(ValueError, match="16px"):
        model(x, x, tps)


def test_gradients_reach_every_parameter(ae_runs):
    missing = [n for n, p in ae_runs["model"].named_parameters() if n not in ae_runs["grads"]]
    assert not missing, missing


def test_kth_ae_training_config_reads_the_yaml():
    cfg = kth_ae_training_config()
    m = cfg["model"]
    assert m["num_regions"] == 10 and cfg["frame_shape"] == 64
    assert m["loss_weights"]["perceptual"] == [10] * 5 and m["scales"] == (1, 0.5, 0.25)
    assert m["transform_params"] == dict(sigma_affine=0.05, sigma_tps=0.005, points_tps=5)
    assert (cfg["lr"], cfg["milestones"], cfg["gamma"]) == (2e-4, (150000,), 0.5)
    assert cfg["device_augment"]["flip_param"] == {"horizontal_flip": True, "time_flip": False}
    from extdm_tpu.config import ae_model_kwargs, load_config

    assert m == ae_model_kwargs(load_config(str(KTH_AE_YAML)))
