"""Tensor parallelism of the port (extdm_tpu_torch.parallel.tensor and
``DMTrainer(mesh=...)``) against the JAX package's rule and GSPMD step, on
the CPU, float32.

- The rule, no spawn: at model 2 and 4, ``param_plan`` gives each port
  tensor the decision of its JAX leaves under ``_param_spec`` (split on
  the output axis, or replicated), leaf by leaf, on the tiny UNet's real
  JAX tree and, from shapes alone (``jax.eval_shape``; the port's UNet on
  the meta device), on ``kth_training_config``'s. The JAX leaves reach the
  port keys through convert.py's key map, each leaf marked by its index;
  a split leaf's port axis is 0, but 1 for a ConvTranspose3d weight
  (``Upsample``). An init conv whose two JAX leaves disagree is refused.
- The step, one world-4 gloo spawn for the file (``torch_tp_ranks``):
  the (data 2, model 2) step against the port's single-process step on the
  global batch with the same t and noise (loss 1e-5, every parameter
  rtol 2e-4 / atol 2e-5: tests/test_parallel.py:126-130's bounds, but for
  the weights whose gradient (in any step so far) is below
  ``ADAM_SIGN_FLOOR``: Adam moves a
  weight by lr g / (|g| + 1e-8) (its first step, and its later ones where
  the moments are as small), so where |g| is near 1e-8 the float32
  differences of a reduction order (the rows' gradients summed apart)
  move it by up to 2 lr a step, which bounds them) and
  against JAX's ``jax.jit(trainer.train_step)`` on ``make_mesh(model=2)``
  over 4 CPU devices with ``shard_params`` (fed JAX's draws, compiled once
  at XLA's lowest optimisation level), the same bounds; the hybrid (dcn 2,
  data 1, model 2) step equals the (2, 2) step exactly; each rank stores
  its slices, the replicated leaves (bit-identical on every rank) and
  moments of those shapes, the UNet's ruled tensors emptied.
- Checkpoints: tensor parallel -> data parallel -> tensor parallel, each
  payload (whole weights and moments) against the single process's chain.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import torch_parallel_ranks as ranks
import torch_tp_ranks
from extdm_tpu.models.dm.flow_diffusion import FlowDiffusion as JFlowDiffusion
from extdm_tpu.models.dm.flow_diffusion import FlowDiffusionConfig as JConfig
from extdm_tpu.parallel.mesh import _param_spec, make_mesh
from extdm_tpu.parallel.mesh import shard_batch as j_shard_batch
from extdm_tpu.parallel.mesh import shard_params as j_shard_params
from extdm_tpu.train import dm_trainer as j_dm
from extdm_tpu_torch import config, convert
from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusionConfig
from extdm_tpu_torch.parallel import param_plan
from extdm_tpu_torch.train.checkpoint import dm_payload, restore_dm
from test_torch_train import _jax_draws as dm_draws
from torch_port_helpers import random_variables, tiny_flow_params

t_ = torch.from_numpy
WORLD = 4
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
# __graft_entry__._tiny_fd's UNet (two levels), with the 1000 steps of the draws
CFG = dict(cond_frames=2, pred_frames=2, frame_shape=32, timesteps=1000, sampling_timesteps=3,
           dim=16, dim_mults=(1, 2), attn_heads=2, attn_dim_head=8)
LR, MILESTONES, GAMMA = 1e-4, (100,), 0.5
BATCH = 4
RTOL, ATOL = 2e-4, 2e-5
ADAM_SIGN_FLOOR = 1e-6


def _flat(tree):
    return {"/".join(str(getattr(q, "key", q)) for q in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def jax_plan(params, model, devices) -> dict:
    """JAX's decision for each port key: the port key's JAX leaves marked
    by index and carried through convert.py's key map, each leaf's
    ``_param_spec`` on a (1, model) mesh; the port axis a split leaf
    takes: 1 for a ConvTranspose3d weight (``Upsample``, ups.i.6), else 0."""
    mesh = make_mesh(data=1, model=model, devices=devices[:model])
    leaves = list(_flat(params).items())
    split = []
    marked = {}
    for i, (path, leaf) in enumerate(leaves):
        spec = _param_spec(tuple(jax.tree_util.DictKey(k) for k in path.split("/")), leaf, mesh)
        split.append(spec == P(*((None,) * (len(leaf.shape) - 1) + ("model",))))
        node = marked
        *head, name = path.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[name] = np.broadcast_to(np.float32(i + 1), leaf.shape)
    out = {}
    for key, marks in convert.unet_arrays(marked).items():
        ids = {int(marks.min()) - 1, int(marks.max()) - 1}
        decisions = {split[i] for i in ids}
        assert len(decisions) == 1, (key, [leaves[i][0] for i in ids])
        out[key] = (1 if key.startswith("ups.") and key.endswith(".6.weight") else 0
                    ) if decisions.pop() else None
    return out


def jax_unet_shapes(cfg):
    jfd = JFlowDiffusion(JConfig(remat=False, **cfg))
    return jax.eval_shape(jfd.init_variables, jax.random.PRNGKey(0))


@pytest.mark.parametrize("model", [2, 4])
def test_rule_matches_jax_on_the_tiny_unet(devices, model):
    shapes = jax_unet_shapes(dict(CFG, flow_params=tiny_flow_params()))
    params = random_variables(dict(shapes[1]["params"]), 2)
    want = jax_plan(params, model, devices)
    got = param_plan({k: v.numpy() for k, v in convert.unet_state_dict(params).items()}, model)
    assert got == want
    assert {a for a in got.values()} == {None, 0, 1}  # Upsample's dim 1 among them
    assert got["init_conv.weight"] == 0  # the split init conv, both leaves ruled


@pytest.mark.parametrize("model", [2, 4])
def test_rule_matches_jax_on_the_kth_unet_from_shapes(devices, model):
    """kth_training_config's UNet: JAX's leaves from jax.eval_shape, the
    port's from a UNet on the meta device. Nearly every parameter is in a
    ruled leaf."""
    cfg = config.kth_training_config()
    jcfg = {f: getattr(cfg, f) for f in ("flow_params", "cond_frames", "pred_frames",
                                         "frame_shape", "timesteps", "sampling_timesteps", "dim",
                                         "dim_mults", "attn_heads", "attn_dim_head")}
    params = jax_unet_shapes(jcfg)[1]["params"]
    want = jax_plan(params, model, devices)
    with torch.device("meta"):
        state = cfg.make_unet().state_dict()
    got = param_plan(state, model)
    assert got == want
    total = sum(v.numel() for v in state.values())
    ruled = sum(v.numel() for k, v in state.items() if got[k] is not None)
    assert total > 200e6 and ruled / total > 0.999


def test_rule_refuses_an_init_conv_whose_leaves_disagree():
    """dim 8: JAX's init_conv (7 x 7 x 3 x 8 = 1176 < 2048) stays
    replicated, its init_conv_cond is split; the port holds one tensor."""
    cfg = FlowDiffusionConfig(**dict(CFG, flow_params=tiny_flow_params(), dim=8))
    with torch.device("meta"):
        state = cfg.make_unet().state_dict()
    with pytest.raises(ValueError, match="init_conv.weight: its JAX leaves disagree"):
        param_plan(state, 2)


# --------------------------------------------------------------- the steps
def jax_step(devices, lfae_vars, unet_params, video, key):
    """JAX's step under GSPMD on a (data 2, model 2) mesh with the TP rule."""
    jfd = JFlowDiffusion(JConfig(flow_params=tiny_flow_params(), remat=False, **CFG))
    trainer = j_dm.DMTrainer(jfd, j_dm.make_optimizer(LR, MILESTONES, GAMMA))
    mesh = make_mesh(data=2, model=2, devices=devices[:WORLD])
    state = trainer.init_state({"params": unet_params})
    params = j_shard_params(state.unet_params, mesh)
    state = type(state)(step=state.step, unet_params=params, opt_state=trainer.tx.init(params))
    lv = jax.device_put(lfae_vars, NamedSharding(mesh, P()))
    vid = j_shard_batch(jnp.asarray(video), mesh)
    with mesh:
        step = jax.jit(trainer.train_step).lower(state, lv, key, vid).compile(FAST_COMPILE)
        new_state, aux = step(state, lv, key, vid)
    return (convert.unet_state_dict(jax.tree_util.tree_map(np.asarray, new_state.unet_params)),
            {k: float(v) for k, v in aux.items()})


def _single_chain(inp, n):
    """The single process's payloads after 1..n steps, each resumed from
    the one before by a new trainer, each step's gradients, the first
    step's aux."""
    out, grads = [], []
    for i in range(n):
        trainer = ranks.dm_trainer(inp)
        if out:
            restore_dm(out[-1], trainer.fd.unet, trainer.optimizer)
        aux = trainer.train_step(None, inp["video"], t=inp["t"], noise=inp["noise"])
        out.append(dm_payload(trainer.fd.unet, trainer.optimizer, i + 1, (i + 1) * BATCH))
        grads.append({k: p.grad.clone() for k, p in trainer.fd.unet.named_parameters()})
        if i == 0:
            first_aux = {k: v.item() for k, v in aux.items()}
    return out, grads, first_aux


@pytest.fixture(scope="module")
def runs(devices, tmp_path_factory):
    shapes = jax_unet_shapes(dict(CFG, flow_params=tiny_flow_params()))
    lfae_vars = random_variables(dict(shapes[0]), 1)
    unet_params = random_variables(dict(shapes[1]["params"]), 2)
    video = np.random.default_rng(42).uniform(size=(BATCH, 4, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(43)
    jax_params, jax_aux = jax_step(devices, lfae_vars, unet_params, video, key)
    t, noise = dm_draws(key, BATCH, (BATCH, CFG["pred_frames"], 16, 16, 3))
    inp = {"flow_params": tiny_flow_params(), "cfg": CFG,
           "lfae": convert.lfae_state_dict(lfae_vars),
           "unet": convert.unet_state_dict(unet_params),
           "video": t_(video), "t": t, "noise": noise, "opt": (LR, MILESTONES, GAMMA)}
    single, grads, single_aux = _single_chain(inp, 3)
    tmp = tmp_path_factory.mktemp("tensor_parallel")
    torch.save(inp, tmp / "inputs.pt")
    ranks.spawn(torch_tp_ranks.steps, WORLD, str(tmp / "store"), str(tmp / "inputs.pt"),
                str(tmp), limit_s=240.0)
    got = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return dict(got=got, single=single, grads=grads, single_aux=single_aux, jax_params=jax_params,
                jax_aux=jax_aux, unet=inp["unet"])


def _weights(payload):
    return {k[len("denoise_fn."):]: v for k, v in payload["diffusion"].items()}


def _close(got, want, grads, what):
    """Every parameter within RTOL / ATOL of `want`, but where the gradient
    of one of the steps (`grads`, one dict a step) was below
    ADAM_SIGN_FLOOR: there within 2 lr a step."""
    assert sorted(got) == sorted(want), what
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        sign = np.any([np.abs(g[k].numpy()) < ADAM_SIGN_FLOOR for g in grads], axis=0)
        np.testing.assert_allclose(a[~sign], b[~sign], rtol=RTOL, atol=ATOL, err_msg=f"{what} {k}")
        assert np.abs(a[sign] - b[sign]).max(initial=0.0) <= 2 * LR * len(grads), (what, k)


def test_tp_step_equals_the_single_step(runs):
    want = _weights(runs["single"][0])
    for r, g in enumerate(runs["got"]):
        tp = g["tp"]
        assert tp["place"] == (r // 2, r % 2, 1)
        np.testing.assert_allclose(tp["aux"]["loss"], runs["single_aux"]["loss"], rtol=1e-5)
        np.testing.assert_allclose(tp["aux"]["grad_norm"], runs["single_aux"]["grad_norm"],
                                   rtol=1e-4)
        _close(tp["whole"], want, runs["grads"][:1], f"rank {r}")
        assert tp["exchanges"] == {"tp_gather": 1, "grad": 1, "aux": 1}


def test_tp_step_matches_jax_gspmd_step(runs):
    assert np.isfinite(runs["jax_aux"]["loss"])
    for r, g in enumerate(runs["got"]):
        np.testing.assert_allclose(g["tp"]["aux"]["loss"], runs["jax_aux"]["loss"], rtol=1e-5)
        _close(g["tp"]["whole"], runs["jax_params"], runs["grads"][:1], f"rank {r} vs JAX")


def test_hybrid_step_equals_the_22_step_exactly(runs):
    for r, g in enumerate(runs["got"]):
        hy, tp = g["hybrid"], g["tp"]
        assert hy["place"] == (r // 2, r % 2, 2)
        assert hy["aux"] == tp["aux"]
        assert all(torch.equal(hy["whole"][k], v) for k, v in tp["whole"].items())


def test_each_rank_holds_its_slices_and_the_replicated_leaves(runs):
    """Stored: each ruled slice with its two moments, each replicated leaf
    whole with its two moments (bit-identical on every rank), AdamW's step
    counts; the UNet's ruled tensors are empty."""
    plan = param_plan({k: v.numpy() for k, v in runs["unet"].items()}, 2)
    whole = runs["got"][0]["tp"]["whole"]
    # float32 weights and two moments (half of each ruled tensor), a step count each
    resident = sum(12 * v.numel() // (1 if plan[k] is None else 2) + 4 for k, v in whole.items())
    for r, g in enumerate(runs["got"]):
        tp, m = g["tp"], r % 2
        assert sorted(tp["shards"]) == sorted(k for k, a in plan.items() if a is not None)
        for k, s in tp["shards"].items():
            n = whole[k].shape[plan[k]] // 2
            assert torch.equal(s, whole[k].narrow(plan[k], m * n, n)), k
            assert tp["unet_numel"][k] == 0
            assert tp["moments"][k] == {"step": torch.Size([]), "exp_avg": s.shape,
                                        "exp_avg_sq": s.shape}
        assert sorted(tp["replicated"]) == sorted(k for k, a in plan.items() if a is None)
        for k, v in tp["replicated"].items():
            assert torch.equal(v, runs["got"][0]["tp"]["replicated"][k]), (r, k)
        assert tp["resident_bytes"] == resident


def test_checkpoints_cross_mesh_shapes(runs):
    """(2, 2) tensor parallel -> data parallel over 4 ranks -> (2, 2)
    tensor parallel: each payload, written from every rank's gathered
    whole, equals the single process's after as many steps."""
    for r, g in enumerate(runs["got"]):
        for i, (got, want) in enumerate(zip(g["chain"], runs["single"])):
            assert (got["step"], got["example"]) == (want["step"], want["example"])
            _close(_weights(got), _weights(want), runs["grads"][:i + 1],
                   f"rank {r} payload {i}")
            go, wo = got["optimizer"], want["optimizer"]
            assert (go["count"], go["notfinite_count"]) == (wo["count"], wo["notfinite_count"])
            assert sorted(go["state"]) == sorted(wo["state"])
            for idx, st in wo["state"].items():
                for k in ("exp_avg", "exp_avg_sq"):
                    np.testing.assert_allclose(go["state"][idx][k].numpy(), st[k].numpy(),
                                               rtol=RTOL, atol=ATOL,
                                               err_msg=f"rank {r} payload {i} {idx} {k}")
                assert float(go["state"][idx]["step"]) == float(st["step"])
