"""Data parallelism of the port (extdm_tpu_torch.parallel, the
data-parallel DM step, SyncBN, the sharded sampler) against the JAX
package's shard_map programs on 2 CPU devices, on the CPU, float32. The AE
step is in test_torch_parallel_ae.py, the jobs in
test_torch_parallel_jobs.py.

The port runs as 2-rank gloo groups in spawned processes
(``torch_parallel_ranks``: the spawn start method, a file store per group,
so that test workers never race for a port); this process holds the JAX
side, which compiles each program once for the file.

- SyncBN: BatchNorm under ``sync_bn_group`` against flax's BatchNorm under
  ``sync_bn_axis`` in a shard_map (tests/test_parallel.py:252-292): output,
  running statistics and the input and weight gradients of a sum against a
  fixed cotangent, rtol 1e-4 / atol 1e-5.
- The DM step at world 2 against JAX ``shard_mapped_train_step``, the port
  fed each shard's t and noise replayed from ``fold_in(key, shard)``:
  parameters within 2e-4 (two learning rates of Adam's first step, whose
  sign is noise where a gradient is near 0); and against the port's
  single-process step on the global batch with the same draws, 1e-5.
- The sharded sampler: bit for bit the plain sampler on each rank's rows
  with that rank's generator; against JAX's ``make_sharded_sampler`` given
  JAX's per-shard x_T (DDIM at eta 0), 1e-3 (the eval test's bound).
- The collectives on known values; the rank rule against
  ``make_data_mesh``; the loader's rows; the refusals of ``init_data_group``.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_parallel_ranks as ranks
from extdm_tpu.models.dm.flow_diffusion import FlowDiffusion as JFlowDiffusion
from extdm_tpu.models.dm.flow_diffusion import FlowDiffusionConfig as JConfig
from extdm_tpu.parallel.mesh import make_data_mesh, make_mesh
from extdm_tpu.train import dm_trainer as j_dm
from extdm_tpu_torch import convert
from extdm_tpu_torch.data import DataLoader
from extdm_tpu_torch.parallel import World, data_ranks, init_data_group, make_data_group
from extdm_tpu_torch.parallel import mesh as mesh_mod
from extdm_tpu_torch.parallel.mesh import DataGroup
from test_torch_sampler import _jax_draws as sampler_draws
from test_torch_train import _jax_draws as dm_draws
from torch_port_helpers import close, random_variables, tiny_flow_params

t_ = torch.from_numpy
WORLD = 2
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
DM_CFG = dict(cond_frames=2, pred_frames=2, frame_shape=32, timesteps=1000, sampling_timesteps=2,
              ddim_eta=0.0, dim=16, dim_mults=(1,), attn_heads=2, attn_dim_head=8)
LR, MILESTONES, GAMMA = 1e-4, (100,), 0.5
DM_BATCH, AE_BATCH, SAMPLER_BATCH = 4, 8, 4


def fast(fn, *args):
    return fn.lower(*args).compile(FAST_COMPILE)


def as_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------------ JAX side
def jax_syncbn(mesh):
    import flax.linen as nn

    from extdm_tpu.nn.layers import BatchNorm, sync_bn_axis

    class M(nn.Module):
        @nn.compact
        def __call__(self, x):
            return BatchNorm(use_running_average=False)(x)

    rng = np.random.default_rng(40)
    x = rng.uniform(size=(8, 6, 6, 5)).astype(np.float32) * 3.0 - 1.0
    cot = rng.normal(size=x.shape).astype(np.float32)
    m = M()
    variables = random_variables(dict(jax.eval_shape(m.init, jax.random.PRNGKey(0), x[:2])), 41)

    def body(v, xl):
        with sync_bn_axis("data"):
            return m.apply(v, xl, mutable=["batch_stats"])

    fn = jax.shard_map(body, mesh=mesh, in_specs=(P(), P("data")), out_specs=(P("data"), P()),
                       check_vma=False)

    def loss(params, xx):
        out, mut = fn({"params": params, "batch_stats": variables["batch_stats"]}, xx)
        return (out * cot).sum(), (out, mut)

    (dparams, dx), (out, mut) = jax.jit(jax.grad(loss, argnums=(0, 1), has_aux=True))(
        variables["params"], jnp.asarray(x))
    bn = lambda tree: as_np(tree)["BatchNorm_0"]["bn"]  # noqa: E731
    params, stats = bn(variables["params"]), bn(variables["batch_stats"])
    state = {"weight": t_(params["scale"]), "bias": t_(params["bias"]),
             "running_mean": t_(stats["mean"]), "running_var": t_(stats["var"])}
    new_stats, grads = bn(mut["batch_stats"]), bn(dparams)
    want = {"y": np.asarray(out), "running_mean": new_stats["mean"],
            "running_var": new_stats["var"], "dx": np.asarray(dx), "dweight": grads["scale"],
            "dbias": grads["bias"]}
    return {"x": t_(x), "cot": t_(cot), "state": state}, want


def jax_dm(mesh):
    """JAX's DM shard_map step and sharded sampler on the tiny config, and
    the port's inputs: the converted weights, each shard's draws."""
    jfd = JFlowDiffusion(JConfig(flow_params=tiny_flow_params(), remat=False, **DM_CFG))
    shapes = jax.eval_shape(jfd.init_variables, jax.random.PRNGKey(0))
    lfae_vars = random_variables(dict(shapes[0]), 1)
    unet_params = random_variables(dict(shapes[1]["params"]), 2)
    video = np.random.default_rng(42).uniform(size=(DM_BATCH, 4, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(43)
    trainer = j_dm.DMTrainer(jfd, j_dm.make_optimizer(LR, MILESTONES, GAMMA))
    state = trainer.init_state({"params": unet_params})
    step = trainer.shard_mapped_train_step(mesh, donate=False)
    args = (state, lfae_vars, key, jnp.asarray(video))
    new_state, aux = fast(step, *args)(*args)
    per = DM_BATCH // WORLD
    x_shape = (per, DM_CFG["pred_frames"], 16, 16, 3)
    draws = [dm_draws(jax.random.fold_in(key, i), per, x_shape) for i in range(WORLD)]
    weights = {"flow_params": tiny_flow_params(), "cfg": DM_CFG,
               "lfae": convert.lfae_state_dict(lfae_vars),
               "unet": convert.unet_state_dict(unet_params)}
    dm_inp = dict(weights, video=t_(video), t=torch.cat([d[0] for d in draws]),
                  noise=torch.cat([d[1] for d in draws]), opt=(LR, MILESTONES, GAMMA))
    dm_want = {"params": convert.unet_state_dict(as_np(new_state.unet_params)),
               "aux": {k: float(v) for k, v in aux.items()}}

    cond = np.random.default_rng(44).uniform(
        size=(SAMPLER_BATCH, DM_CFG["cond_frames"], 32, 32, 3)).astype(np.float32)
    skey = jax.random.PRNGKey(45)
    sampler = jfd.make_sharded_sampler(lfae_vars, {"params": unet_params}, mesh)
    sample_want = {k: np.asarray(v) for k, v in sampler(skey, jnp.asarray(cond)).items()
                   if v is not None}
    per = SAMPLER_BATCH // WORLD
    x_T = [sampler_draws(jax.random.fold_in(skey, i), (per, DM_CFG["pred_frames"], 16, 16, 3),
                         0)[0] for i in range(WORLD)]
    sampler_inp = dict(weights, cond=t_(cond), x_T=t_(np.concatenate(x_T)), seed=46)
    return dm_inp, dm_want, sampler_inp, sample_want


@pytest.fixture(scope="module")
def runs(devices, tmp_path_factory):
    """Every JAX program once, the port's single-process global-batch step,
    then one spawn of 2 ranks running every case (``ranks.cases``)."""
    mesh = make_mesh(model=1, devices=devices[:WORLD])
    syncbn_inp, syncbn_want = jax_syncbn(mesh)
    dm_inp, dm_want, sampler_inp, sample_want = jax_dm(mesh)

    torch.manual_seed(0)
    single_dm = ranks.dm_trainer(dm_inp)
    aux = single_dm.train_step(None, dm_inp["video"], t=dm_inp["t"], noise=dm_inp["noise"])
    single = {"dm": {"aux": {k: v.item() for k, v in aux.items()},
                     "params": dict(single_dm.fd.unet.named_parameters()),
                     "grads": {n: p.grad for n, p in single_dm.fd.unet.named_parameters()}}}
    got = ranks.run_cases({"syncbn": syncbn_inp, "dm": dm_inp, "sampler": sampler_inp,
                           "collectives": {}}, tmp_path_factory.mktemp("parallel"), WORLD)
    return dict(got=got, single=single, syncbn=syncbn_want, dm=dm_want, sampler=sample_want)


# --------------------------------------------------------------------- SyncBN
def test_sync_bn_matches_jax_shard_map(runs):
    want, got = runs["syncbn"], runs["got"]
    y = torch.cat([g["syncbn"]["y"] for g in got])
    dx = torch.cat([g["syncbn"]["dx"] for g in got])
    for name, value in (("y", y), ("dx", dx)):
        np.testing.assert_allclose(value.numpy(), want[name], rtol=1e-4, atol=1e-5, err_msg=name)
    for name in ("dweight", "dbias"):  # d(sum over both ranks' rows) / d(shared weights)
        value = sum(g["syncbn"][name] for g in got)
        np.testing.assert_allclose(value.numpy(), want[name], rtol=1e-4, atol=1e-5, err_msg=name)
    for g in got:  # every rank moves its running statistics by the global batch's
        for name in ("running_mean", "running_var"):
            np.testing.assert_allclose(g["syncbn"][name].numpy(), want[name], rtol=1e-4,
                                       atol=1e-5, err_msg=name)


# ------------------------------------------------------------------- DM step
def test_dm_step_at_world_2_matches_jax_shard_map(runs):
    want = runs["dm"]
    for g in runs["got"]:
        got = g["dm"]
        assert sorted(got["params"]) == sorted(want["params"])
        for name, p in got["params"].items():
            np.testing.assert_allclose(p.numpy(), want["params"][name].numpy(), rtol=0,
                                       atol=2 * LR, err_msg=name)
        close(got["aux"]["loss"], want["aux"]["loss"], 1e-5)
        close(got["aux"]["grad_norm"], want["aux"]["grad_norm"], 2e-4)


def test_dm_step_at_world_2_equals_the_global_batch_step(runs):
    single = runs["single"]["dm"]
    for g in runs["got"]:
        got = g["dm"]
        for name, p in got["params"].items():
            close(p, single["params"][name].detach(), 1e-5)
            ref = single["grads"][name]
            np.testing.assert_allclose(got["grads"][name].numpy(), ref.numpy(), rtol=0,
                                       atol=1e-5 * max(ref.abs().max().item(), 1e-12),
                                       err_msg=name)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got["aux"][k], single["aux"][k], rtol=1e-5, err_msg=k)
    # every rank applied the same averaged gradients
    a, b = (g["dm"]["params"] for g in runs["got"])
    assert all(torch.equal(a[n], b[n]) for n in a)


# ------------------------------------------------------------------- sampler
def test_sharded_sampler_equals_the_plain_sampler_on_each_ranks_rows(runs):
    for g in runs["got"]:
        s = g["sampler"]
        assert set(s["drawn"]) == set(s["own"])
        for k, v in s["drawn"].items():
            if v is None:
                assert s["own"][k] is None
                continue
            assert v.shape[0] == SAMPLER_BATCH, k
            assert torch.equal(v[s["rows"]], s["own"][k]), k
    a, b = (g["sampler"]["drawn"] for g in runs["got"])
    assert all(a[k] is None or torch.equal(a[k], b[k]) for k in a)


def test_sharded_sampler_matches_jax_given_its_draws(runs):
    want = runs["sampler"]
    for g in runs["got"]:
        given = g["sampler"]["given"]
        assert sorted(k for k, v in given.items() if v is not None) == sorted(want)
        for k, v in want.items():
            np.testing.assert_allclose(given[k].numpy(), v, rtol=1e-3, atol=1e-3, err_msg=k)


# --------------------------------------------------------------- collectives
def test_collectives_on_known_values(runs):
    for r, g in enumerate(runs["got"]):
        c = g["collectives"]
        assert c["means"]["a"].item() == 0.5 and torch.equal(c["means"]["b"],
                                                             torch.full((2, 3), 1.0))
        v = c["gathered"]["v"]
        assert v.dtype == torch.bfloat16 and c["gathered"]["none"] is None
        assert torch.equal(v, torch.arange(8, dtype=torch.bfloat16).reshape(4, 2))
        # y = (x0 + x1) / 2 = 1.5 on both; dx_r = mean over ranks of dy = (1 + 2) / 2
        assert c["y"].item() == 1.5 and c["dx"].item() == 1.5


@pytest.mark.parametrize("batch,world", [(8, 2), (8, 3), (6, 4), (2, 4), (1, 2), (7, 4),
                                         (12, 8), (5, 5)])
def test_data_group_rule_matches_make_data_mesh(devices, capsys, monkeypatch, batch, world):
    """The ranks of a global batch and the line that says so against
    make_data_mesh on `world` devices; their process group, ranks 0..n-1."""
    mesh = make_data_mesh(batch, devices[:world])
    jax_line = capsys.readouterr().out
    monkeypatch.setattr(mesh_mod, "dist", SimpleNamespace(
        new_group=lambda ranks: ("subgroup", tuple(ranks))))
    for rank in range(world):
        group = make_data_group(batch, World(rank=rank, size=world, local_rank=rank,
                                             device=torch.device("cpu"), backend="gloo"))
        assert group.size == data_ranks(batch, world) == mesh.shape["data"]
        assert capsys.readouterr().out == jax_line
        n = group.size
        assert group.group == ("subgroup", tuple(range(n)))
        assert group.rank == (rank if rank < n else -1)


def test_loader_gives_each_rank_its_rows_of_the_global_batch():
    """Rank r of n loads rows [r B / n, (r + 1) B / n) of each batch of the
    single-process permutation."""
    data = list(range(12))
    whole = [list(b) for b in DataLoader(data, 4, num_workers=0, seed=3)]
    for r in range(2):
        group = DataGroup(size=2, rank=r, world=None)
        part = [list(b) for b in DataLoader(data, 4, num_workers=0, seed=3, group=group)]
        assert part == [b[2 * r:2 * r + 2] for b in whole]


def test_init_refuses_what_it_cannot_serve():
    with pytest.raises(RuntimeError, match="takes no CPU tensors"):
        init_data_group("nccl", "cpu")
    with pytest.raises(ValueError, match="one of"):
        init_data_group("mpi", "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_data_group("nccl", "cuda")
    world = init_data_group("gloo", "cpu")  # no torchrun variables: a world of one
    assert (world.rank, world.size, world.device) == (0, 1, torch.device("cpu"))


