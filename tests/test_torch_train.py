"""Port DM training (extdm_tpu_torch.train, FlowDiffusion.loss and the
backward of the kernel layers) against the JAX package on the CPU, float32.

- The plain backward of each kernel layer (what its backward wrapper runs
  for CPU tensors) against jax.vjp of the JAX reference with a non-uniform
  cotangent, on every gradient: to 5e-4 for the attention layers
  (tests/test_pallas_stw.py's gradient bound), rtol 2e-4 / atol 2e-5 for the
  resnet block (tests/test_pallas_resnet.py's).
- q_sample / p_losses with the JAX draw of t and noise, multi_step, and one
  and two AdamW steps (with and without the nan guard) against optax.
- A whole train step at the tiny config of tests/test_torch_dm.py against
  DMTrainer.train_step.
- The bf16 policy: float32 parameters, a bf16 activation stream, float32
  gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extdm_tpu.models.dm import diffusion as j_diff
from extdm_tpu.models.dm.flow_diffusion import FlowDiffusion as JFlowDiffusion
from extdm_tpu.models.dm.flow_diffusion import FlowDiffusionConfig as JConfig
from extdm_tpu.nn.attention import _relative_position_index, get_window_size
from extdm_tpu.ops import pallas_resnet, pallas_stw
from extdm_tpu.train import dm_trainer as j_trainer
from extdm_tpu.train.lr_schedule import multi_step as j_multi_step
from extdm_tpu_torch import convert
from extdm_tpu_torch.models.dm import diffusion
from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusion, FlowDiffusionConfig
from extdm_tpu_torch.models.dm.unet3d import Unet3D
from extdm_tpu_torch.ops import fused_resnet, fused_stw
from extdm_tpu_torch.train import dm_trainer
from extdm_tpu_torch.train.lr_schedule import multi_step
from torch_port_helpers import close, random_variables, tiny_flow_params

t_ = torch.from_numpy


def jax_vjp(fn, g, *args):
    """jax.vjp of fn at args for the cotangent g, under one jit (an eager
    flax/jnp backward compiles every primitive on its own)."""
    return jax.jit(lambda g, *a: jax.vjp(fn, *a)[1](g))(jnp.asarray(g), *map(jnp.asarray, args))


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


def _attn_params(rng, C, heads, dh):
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    hid = heads * dh
    return dict(gamma=1.0 + 0.1 * f(C), w_qkv=0.2 * f(C, 3 * hid), w_proj=0.2 * f(hid, C),
                b_proj=0.05 * f(C), ln_scale=1.0 + 0.1 * f(C), ln_bias=0.1 * f(C))


# ------------------------------------------------------------ layer backwards
@pytest.mark.parametrize("shape,shift", [
    ((1, 8, 8, 8, 16), (2, 2, 2)),   # shifted
    ((1, 8, 8, 8, 16), (0, 0, 0)),   # unshifted
    ((1, 6, 4, 8, 16), (2, 2, 2)),   # T not a multiple of the window, clamped H window
])
def test_stw_backward_matches_jax(shape, shift):
    window, heads, dh = (4, 4, 4), 2, 8
    B, T, H, W, C = shape
    rng = np.random.default_rng(10)
    p = _attn_params(rng, C, heads, dh)
    win, sh = get_window_size((T, H, W), window, shift)
    N = win[0] * win[1] * win[2]
    table = 0.5 * rng.normal(size=((2 * 4 - 1) ** 3, heads)).astype(np.float32)
    bias = np.transpose(table[_relative_position_index(window)[:N, :N].reshape(-1)]
                        .reshape(N, N, heads), (2, 0, 1)).copy()
    x = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    kw = dict(window=win, shift=sh, heads=heads, dim_head=dh)
    margs = _mask_args(T, H, W, win, sh)

    def ref(x, gamma, wq, wp, bp, b):
        return pallas_stw.stw_layer_reference(x, gamma, wq, wp, bp, b, *margs, rotary=True, **kw)

    want = jax_vjp(ref, g, x, p["gamma"], p["w_qkv"], p["w_proj"], p["b_proj"], bias)
    before = fused_stw.stw_layer_bwd.launches
    got = fused_stw.stw_layer_bwd(t_(g), t_(x), t_(p["gamma"]), t_(p["w_qkv"].T.copy()),
                                  t_(p["w_proj"].T.copy()), t_(p["b_proj"]), t_(bias), **kw)
    assert fused_stw.stw_layer_bwd.launches == before  # the CPU takes the plain backward
    got = [got[0], got[1], got[2].T, got[3].T, got[4], got[5]]
    for name, a, b in zip(("dx", "dgamma", "dwqkv", "dwproj", "dbproj", "dbias"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-4, atol=5e-4, err_msg=name)


def _reduce_thw(pb):
    """The 4-D THW bias as PreNormTemporalAttn reduces it: per query, over keys."""
    heads, T = pb.shape[:2]
    if isinstance(pb, torch.Tensor):
        return pb.mean(dim=(-2, -1))[:, :, None].expand(heads, T, T)
    return jnp.broadcast_to(pb.mean(axis=(-2, -1))[:, :, None], (heads, T, T))


@pytest.mark.parametrize("bias_kind", ["t5", "thw"])
def test_temporal_backward_matches_jax(bias_kind):
    heads, dh = 2, 8
    B, T, H, W, C = 1, 7, 4, 4, 16
    rng = np.random.default_rng(11)
    p = _attn_params(rng, C, heads, dh)
    pb_shape = (heads, T, T) if bias_kind == "t5" else (heads, T, T, T)
    pos_bias = 0.5 * rng.normal(size=pb_shape).astype(np.float32)
    x = rng.normal(size=(B, T, H, W, C)).astype(np.float32)
    g = rng.normal(size=(B, T, H, W, C)).astype(np.float32)
    reduce = (lambda b: b) if bias_kind == "t5" else _reduce_thw

    def ref(x, gc, s, b, wq, wo, pb):
        return pallas_stw.temporal_layer_reference(x, gc, s, b, wq, wo, reduce(pb), heads=heads,
                                                   dim_head=dh, rotary=True)

    want = jax_vjp(ref, g, x, p["gamma"], p["ln_scale"], p["ln_bias"], p["w_qkv"], p["w_proj"],
                   pos_bias)

    def port(x, gc, s, b, wq, wo, pb):
        return fused_stw.fused_temporal_layer(x, gc, s, b, wq, wo, reduce(pb), heads=heads,
                                              dim_head=dh)

    got = fused_stw.plain_vjp(port, t_(g), t_(x), t_(p["gamma"]), t_(p["ln_scale"]),
                              t_(p["ln_bias"]), t_(p["w_qkv"].T.copy()), t_(p["w_proj"].T.copy()),
                              t_(pos_bias))
    got = [got[0], got[1], got[2], got[3], got[4].T, got[5].T, got[6]]
    names = ("dx", "dgamma_cln", "dln_scale", "dln_bias", "dwqkv", "dwout", "dbias")
    for name, a, b in zip(names, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-4, atol=5e-4, err_msg=name)


@pytest.mark.parametrize("shape,cout,groups,film", [
    ((2, 3, 8, 8, 16), 16, 4, True),     # identity residual + FiLM
    ((2, 3, 8, 8, 16), 32, 8, True),     # residual projection
    ((1, 2, 4, 4, 24), 16, 8, False),    # no FiLM
])
def test_resnet_backward_matches_jax(shape, cout, groups, film):
    cin = shape[-1]
    rng = np.random.default_rng(12)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    p = dict(w1=0.1 * f(1, 3, 3, cin, cout), b1=0.1 * f(cout), g1s=1 + 0.1 * f(cout),
             g1b=0.1 * f(cout), film=0.2 * f(shape[0], 2 * cout) if film else None,
             w2=0.1 * f(1, 3, 3, cout, cout), b2=0.1 * f(cout), g2s=1 + 0.1 * f(cout),
             g2b=0.1 * f(cout), wres=0.1 * f(cin, cout) if cin != cout else None,
             bres=0.1 * f(cout) if cin != cout else None)
    x = f(*shape)
    g = f(*shape[:-1], cout)
    names = [k for k in ("w1", "b1", "g1s", "g1b", "film", "w2", "b2", "g2s", "g2b", "wres",
                         "bres") if p[k] is not None]

    def ref(x, *args):
        q = dict(p, **dict(zip(names, args)))
        return pallas_resnet.resnet_block_reference(
            x, q["w1"], q["b1"], q["g1s"], q["g1b"], q["film"], q["w2"], q["b2"], q["g2s"],
            q["g2b"], q["wres"], q["bres"], groups=groups)

    want = dict(zip(["x"] + names, jax_vjp(ref, g, x, *[p[k] for k in names])))
    conv = lambda w: t_(convert.conv_weight(w).copy())  # noqa: E731
    port = dict(x=t_(x), w1=conv(p["w1"]), w2=conv(p["w2"]),
                wres=None if p["wres"] is None else conv(p["wres"][None, None, None]))
    for k in ("b1", "g1s", "g1b", "film", "b2", "g2s", "g2b", "bres"):
        port[k] = None if p[k] is None else t_(p[k])
    order = ("x", "w1", "b1", "g1s", "g1b", "film", "w2", "b2", "g2s", "g2b", "wres", "bres")
    got = dict(zip(order, fused_resnet.resnet_block_bwd(t_(g), *[port[k] for k in order],
                                                          groups=groups)))
    for k in ("film", "wres", "bres"):
        assert (got[k] is None) == (p.get(k) is None)
    as_jax = {"w1": lambda a: a.permute(2, 3, 4, 1, 0), "w2": lambda a: a.permute(2, 3, 4, 1, 0),
              "wres": lambda a: a.flatten(1).t()}
    for k in ["x"] + names:
        a = as_jax.get(k, lambda a: a)(got[k])
        np.testing.assert_allclose(a.numpy(), np.asarray(want[k]), rtol=2e-4, atol=2e-5,
                                   err_msg=k)


# ------------------------------------------------------ diffusion and optimizer
def _jax_draws(key, b, shape):
    """t and noise as GaussianDiffusion.p_losses draws them from `key`."""
    key_t, key_noise = jax.random.split(key)
    t = jax.random.randint(key_t, (b,), 0, 1000)
    noise = jax.random.normal(key_noise, shape, jnp.float32)
    return torch.from_numpy(np.array(t)).long(), torch.from_numpy(np.array(noise))


@pytest.mark.parametrize("loss_type", ["l2", "l1"])
def test_q_sample_and_p_losses_match_jax(loss_type):
    rng = np.random.default_rng(13)
    x_cond = rng.normal(size=(2, 2, 4, 4, 3)).astype(np.float32)
    x_pred = rng.normal(size=(2, 3, 4, 4, 3)).astype(np.float32)
    w = rng.normal(size=(3, 3)).astype(np.float32)
    jd = j_diff.GaussianDiffusion(j_diff.DiffusionSchedule.create(1000), loss_type=loss_type)
    pd = diffusion.GaussianDiffusion(diffusion.DiffusionSchedule.create(1000), loss_type=loss_type)

    def j_denoise(x, t, c, f):
        return x @ w + c.mean(axis=1, keepdims=True) + t[:, None, None, None, None] * 1e-3

    def p_denoise(x, t, c, f):
        return x @ t_(w) + c.mean(dim=1, keepdim=True) + t[:, None, None, None, None] * 1e-3

    key = jax.random.PRNGKey(7)
    ref_loss, ref_x0 = jd.p_losses(j_denoise, key, jnp.asarray(x_cond), jnp.asarray(x_pred), None)
    t, noise = _jax_draws(key, 2, x_pred.shape)
    loss, x0 = pd.p_losses(p_denoise, None, t_(x_cond), t_(x_pred), None, t=t, noise=noise)
    close(loss, ref_loss, 1e-5)
    close(x0, ref_x0, 1e-5)
    close(pd.q_sample(t_(x_pred), t, noise),
          jd.q_sample(jnp.asarray(x_pred), jnp.asarray(t.numpy()), jnp.asarray(noise.numpy())),
          1e-6)


def test_multi_step_matches_optax():
    ref = j_multi_step(2e-4, (3, 7, 7, 10), 0.5)
    port = multi_step(2e-4, (3, 7, 7, 10), 0.5)
    for step in range(14):
        np.testing.assert_allclose(port(step), float(ref(step)), rtol=1e-6, err_msg=str(step))


@pytest.mark.parametrize("nan_guard", [0, 2])
def test_optimizer_steps_match_optax(nan_guard):
    rng = np.random.default_rng(14)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    nan = {k: np.full(v.shape, np.nan, np.float32) for k, v in params.items()}
    # with the guard: a non-finite step between two finite ones is skipped
    seq = [grads[0], grads[1]] if nan_guard == 0 else [grads[0], nan, nan, grads[1]]
    tx = j_trainer.make_optimizer(1e-2, (1,), 0.5, nan_guard=nan_guard)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    pp = {k: torch.nn.Parameter(t_(v.copy())) for k, v in params.items()}
    opt = dm_trainer.make_optimizer(pp.values(), 1e-2, (1,), 0.5, nan_guard=nan_guard)
    for gr in seq:
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, gr), state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, updates)
        for k, p in pp.items():
            p.grad = t_(gr[k].copy())
        opt.step()
        for k in params:
            close(pp[k].detach(), jp[k], 1e-6)
    if nan_guard:
        assert opt.notfinite_count == 0 and opt.count == 2
        for _ in range(nan_guard):  # skipped, as optax skips them
            for p in pp.values():
                p.grad = torch.full_like(p, float("nan"))
            assert opt.step() is False
        for p in pp.values():
            p.grad = torch.full_like(p, float("nan"))
        with pytest.raises(FloatingPointError):  # where optax gives up and applies NaN
            opt.step()
        for _ in range(nan_guard + 1):
            updates, state = tx.update(nan, state, jp)
            jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, updates)
        assert not np.isfinite(np.asarray(jp["a"])).any()


def test_canonicalize_video_matches_jax():
    rng = np.random.default_rng(15)
    for video in (rng.integers(0, 256, size=(2, 3, 4, 4), dtype=np.uint8),
                  rng.integers(0, 256, size=(2, 3, 4, 4, 1), dtype=np.uint8),
                  rng.uniform(size=(2, 3, 4, 4, 3)).astype(np.float32)):
        close(dm_trainer.canonicalize_video(t_(video)),
              j_trainer.canonicalize_video(jnp.asarray(video)), 0)


# --------------------------------------------------------- whole train step
CFG = dict(cond_frames=2, pred_frames=2, frame_shape=32, timesteps=1000, sampling_timesteps=3,
           ddim_eta=0.0, dim=16, dim_mults=(1, 2), attn_heads=2, attn_dim_head=8)
LR, MILESTONES, GAMMA = 1e-3, (1,), 0.5


def test_train_step_matches_jax():
    jfd = JFlowDiffusion(JConfig(flow_params=tiny_flow_params(), remat=False, **CFG))
    shapes = jax.eval_shape(jfd.init_variables, jax.random.PRNGKey(0))
    lfae_vars = random_variables(dict(shapes[0]), 1)
    unet_params = random_variables(dict(shapes[1]["params"]), 2)
    video = np.random.default_rng(16).uniform(size=(2, 4, 32, 32, 3)).astype(np.float32)
    keys = [jax.random.PRNGKey(21), jax.random.PRNGKey(22)]
    jv = jnp.asarray(video)

    trainer = j_trainer.DMTrainer(jfd, j_trainer.make_optimizer(LR, MILESTONES, GAMMA))
    step = jax.jit(trainer.train_step)
    state = trainer.init_state({"params": unet_params})
    jaux = []
    for key in keys:
        state, aux = step(state, lfae_vars, key, jv)
        jaux.append(aux)
    grad_fn = jax.jit(jax.grad(lambda p: jfd.loss(lfae_vars, {"params": p}, keys[0], jv)[0]))
    jgrads = convert.unet_state_dict(grad_fn(unet_params))

    fd = FlowDiffusion(FlowDiffusionConfig(flow_params=tiny_flow_params(), **CFG), device="cpu")
    fd.lfae.load_state_dict(convert.lfae_state_dict(lfae_vars))
    fd.unet.load_state_dict(convert.unet_state_dict(unet_params))
    port = dm_trainer.DMTrainer(fd, dm_trainer.make_optimizer(fd.unet.parameters(), LR,
                                                              MILESTONES, GAMMA))
    x_shape = (2, CFG["pred_frames"], 16, 16, 3)
    for i, key in enumerate(keys):
        t, noise = _jax_draws(key, 2, x_shape)
        aux = port.train_step(None, t_(video), t=t, noise=noise)
        close(aux["loss"], jaux[i]["loss"], 1e-5)
        close(aux["grad_norm"], jaux[i]["grad_norm"], 2e-4)
        if i == 0:
            names = [n for n, _ in fd.unet.named_parameters()]
            assert sorted(names) == sorted(jgrads)
            for name, p in fd.unet.named_parameters():
                want = np.asarray(jgrads[name])
                tol = 2e-4 * max(np.abs(want).max(), 1e-12)
                np.testing.assert_allclose(p.grad.numpy(), want, rtol=0, atol=tol, err_msg=name)
    assert all(p.grad is None and not p.requires_grad for p in fd.lfae.parameters())
    # Adam's first steps move an element by about lr g / (|g| + eps): where
    # |g| is near eps (or its sign flips) the two packages may differ by up to
    # lr per step, so after two steps the bound is 2 lr; elsewhere they agree.
    ref = convert.unet_state_dict(state.unet_params)
    for name, p in fd.unet.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref[name]), rtol=0,
                                   atol=2 * LR, err_msg=name)


def test_bf16_policy_float32_params_bf16_stream():
    """A bf16 Unet3D keeps float32 parameters and gradients while every
    module output of rank >= 4 is bf16, the UNet's own float32 output aside
    (the port's counterpart of tests/test_dtype_policy.py)."""
    torch.manual_seed(0)
    unet = Unet3D(dim=16, dim_mults=(1, 2), window_size=(2, 2, 2), attn_heads=2,
                  attn_dim_head=4, cond_feature_dim=32, cond_num=2, pred_num=2, remat=True,
                  dtype=torch.bfloat16)
    leaks = []

    def hook(mod, args, out):
        for o in (out if isinstance(out, (tuple, list)) else (out,)):
            if torch.is_tensor(o) and o.ndim >= 4 and o.dtype != torch.bfloat16 and mod is not unet:
                leaks.append((type(mod).__name__, tuple(o.shape), o.dtype))

    handles = [m.register_forward_hook(hook) for m in unet.modules()]
    rng = np.random.default_rng(17)
    x, xc = t_(rng.normal(size=(1, 2, 8, 8, 3)).astype(np.float32)), t_(
        rng.normal(size=(1, 2, 8, 8, 3)).astype(np.float32))
    fea = t_(rng.normal(size=(1, 4, 4, 4, 32)).astype(np.float32))
    out = unet(x, torch.tensor([3]), xc, fea)
    for h in handles:
        h.remove()
    assert out.dtype == torch.float32
    assert not leaks, leaks
    out.square().mean().backward()
    assert all(p.dtype == torch.float32 for p in unet.parameters())
    missing = [n for n, p in unet.named_parameters() if p.grad is None]
    assert not missing, missing
    assert all(p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all()
               for p in unet.parameters())


def test_path1_gradients_reach_thw_bias():
    """With path=1 the THW bias table and alpha / beta get gradients
    through the temporal layers' per-query bias reduction."""
    torch.manual_seed(1)
    unet = Unet3D(dim=16, dim_mults=(1, 2), window_size=(2, 2, 2), attn_heads=2,
                  attn_dim_head=4, cond_feature_dim=32, cond_num=2, pred_num=2, path=1)
    rng = np.random.default_rng(18)
    x, xc = (t_(rng.normal(size=(1, 2, 8, 8, 3)).astype(np.float32)) for _ in range(2))
    fea = t_(rng.normal(size=(1, 4, 4, 4, 32)).astype(np.float32))
    unet(x, torch.tensor([3]), xc, fea).square().mean().backward()
    for p in (unet.alpha, unet.beta, unet.rel_pos_bias_thw.relative_attention_bias.weight):
        assert p.grad is not None and p.grad.abs().max() > 0


def test_sampling_unet_is_a_cast_of_the_master_weights_after_each_step():
    """The bf16 sampler runs a copy of the float32 master weights cast once;
    an optimizer step makes it take a fresh copy."""
    cfg = FlowDiffusionConfig(flow_params=tiny_flow_params(), dtype=torch.bfloat16, **CFG)
    fd = FlowDiffusion(cfg, device="cpu")
    trainer = dm_trainer.DMTrainer(fd, dm_trainer.make_optimizer(fd.unet.parameters(), LR,
                                                                 MILESTONES, GAMMA))
    video = torch.rand(1, 4, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    for step in range(2):
        unet = fd.sampling_unet()
        assert unet is fd.sampling_unet()  # cached while the weights stay
        for (name, p), q in zip(fd.unet.named_parameters(), unet.parameters()):
            assert p.dtype == torch.float32 and q.dtype == torch.bfloat16, name
            assert torch.equal(q, p.detach().to(torch.bfloat16)), name
        trainer.train_step(torch.Generator().manual_seed(step), video)
    assert fd.sampling_unet() is not unet
