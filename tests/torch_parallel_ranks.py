"""The rank side of tests/test_torch_parallel.py: bodies that run in
processes spawned by ``spawn`` (gloo on the CPU, a file store), one per
rank. Imports no JAX: a spawned rank starts from a fresh interpreter, and
the test's parent process holds the JAX side and the inputs, which reach
the ranks through a ``torch.save`` file."""
import os
import time
from contextlib import contextmanager

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

RANK_THREADS = 2


def spawn(fn, world: int, *args, limit_s: float = 240.0) -> None:
    """fn(rank, world, *args) in `world` spawned processes; raises the first
    rank's error, or TimeoutError (the ranks killed) after `limit_s`."""
    ctx = mp.start_processes(fn, args=(world, *args), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + limit_s
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} ranks of {fn.__name__} still running after {limit_s} s")


def _world(rank, world, store):
    from extdm_tpu_torch.parallel import init_data_group

    torch.set_num_threads(RANK_THREADS)
    return init_data_group("gloo", "cpu", rank=rank, world_size=world,
                           init_method=f"file://{store}")


def _rows_tps(tps, rows):
    from extdm_tpu_torch.models.lfae.transform import TPSTransform

    return TPSTransform(*tps).rows(rows)


# ------------------------------------------------------------- step cases
def cases(rank, world, store, inputs_path, out_dir):
    """Each case named in the inputs file (``CASES``: SyncBN, the DM step,
    the AE step, the sharded sampler, the collectives) at `world` ranks;
    each rank saves what it computed to <out_dir>/rank<r>.pt."""
    w = _world(rank, world, store)
    inp = torch.load(inputs_path, weights_only=False)
    out = {name: CASES[name](w, case) for name, case in inp.items()}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def run_cases(inputs, tmp, world):
    """``cases`` at `world` ranks on `inputs` ({case name: its inputs});
    returns what each rank computed."""
    torch.save(inputs, tmp / "inputs.pt")
    spawn(cases, world, str(tmp / "store"), str(tmp / "inputs.pt"), str(tmp))
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _syncbn(w, inp):
    from extdm_tpu_torch.nn.layers import BatchNorm, sync_bn_group
    from extdm_tpu_torch.parallel import make_data_group

    x, cot = inp["x"], inp["cot"]
    group = make_data_group(x.shape[0], w)
    rows = group.rows(x.shape[0])
    bn = BatchNorm(x.shape[-1])
    bn.load_state_dict(inp["state"], strict=False)
    bn.train()
    xl = x[rows].clone().requires_grad_(True)
    with sync_bn_group(group):
        y = bn(xl)
    (y * cot[rows]).sum().backward()
    return {"rows": rows, "y": y.detach(), "running_mean": bn.running_mean.clone(),
            "running_var": bn.running_var.clone(), "dx": xl.grad, "dweight": bn.weight.grad,
            "dbias": bn.bias.grad}


def dm_fd(inp):
    from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusion, FlowDiffusionConfig

    fd = FlowDiffusion(FlowDiffusionConfig(flow_params=inp["flow_params"], **inp["cfg"]),
                       device="cpu")
    fd.lfae.load_state_dict(inp["lfae"])
    fd.unet.load_state_dict(inp["unet"])
    return fd


def dm_trainer(inp, group=None):
    from extdm_tpu_torch.train.dm_trainer import DMTrainer, make_optimizer

    fd = dm_fd(inp)
    return DMTrainer(fd, make_optimizer(fd.unet.parameters(), *inp["opt"]), group=group)


def _dm_step(w, inp):
    from extdm_tpu_torch.parallel import make_data_group, shard_batch

    group = make_data_group(inp["video"].shape[0], w)
    trainer = dm_trainer(inp, group)
    video, t, noise = shard_batch((inp["video"], inp["t"], inp["noise"]), group)
    aux = trainer.train_step(None, video, t=t, noise=noise)
    unet = trainer.fd.unet
    return {"aux": {k: v.item() for k, v in aux.items()},
            "params": {n: p.detach().clone() for n, p in unet.named_parameters()},
            "grads": {n: p.grad.clone() for n, p in unet.named_parameters()}}


def ae_trainer(inp, group=None):
    from extdm_tpu_torch.models.lfae.recon_model import ReconstructionModel
    from extdm_tpu_torch.train.ae_trainer import AETrainer, make_optimizer

    model = ReconstructionModel(**inp["kwargs"])
    model.load_state_dict(inp["state"])
    return AETrainer(model, make_optimizer(*inp["opt"]), device="cpu", group=group)


def _ae_step(w, inp):
    from extdm_tpu_torch.parallel import make_data_group, shard_batch

    B = inp["batch"]["source"].shape[0]
    group = make_data_group(B, w)
    trainer = ae_trainer(inp, group)
    aux = trainer.train_step(None, shard_batch(inp["batch"], group),
                             tps=_rows_tps(inp["tps"], group.rows(B)))
    return {"aux": {k: v.item() for k, v in aux.items()},
            "state": {n: v.detach().clone() for n, v in trainer.model.state_dict().items()},
            "grads": {n: p.grad.clone() for n, p in trainer.model.named_parameters()}}


def _sampler(w, inp):
    from extdm_tpu_torch.parallel import make_data_group, rank_generator

    fd = dm_fd(inp)
    cond = inp["cond"]
    group = make_data_group(cond.shape[0], w)
    rows = group.rows(cond.shape[0])
    sharded = fd.make_sharded_sampler(group)
    seed = inp["seed"]
    drawn = sharded(torch.Generator().manual_seed(seed), cond)
    own = fd.make_sampler()(rank_generator(torch.Generator().manual_seed(seed), group.rank),
                            cond[rows])
    given = sharded(torch.Generator().manual_seed(seed), cond, init_noise=inp["x_T"])
    return {"rows": rows, "drawn": drawn, "own": own, "given": given}


def _collectives(w, inp):
    """all_mean, gather_batch and the autograd mean on known values."""
    from extdm_tpu_torch.parallel import (all_mean, all_mean_autograd, gather_batch,
                                          make_data_group)

    group = make_data_group(2 * w.size, w)
    r = float(w.rank)
    means = all_mean({"a": torch.tensor(r), "b": torch.full((2, 3), 2 * r)}, group)
    rows = torch.arange(4, dtype=torch.bfloat16).reshape(2, 2) + 4 * r
    x = torch.tensor([r + 1.0], requires_grad=True)
    y = all_mean_autograd(x, group)
    (y * (r + 1.0)).sum().backward()
    return {"means": means, "gathered": gather_batch({"v": rows, "none": None}, group),
            "y": y.detach(), "dx": x.grad}


CASES = {"syncbn": _syncbn, "dm": _dm_step, "ae": _ae_step, "sampler": _sampler,
         "collectives": _collectives}


# ------------------------------------------------------------------- jobs
@contextmanager
def _rank_env(rank, world):
    saved = {k: os.environ.get(k) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def jobs(rank, world, store_dir, arch, runs, out_dir):
    """Each (job, argv) of `runs` through its ``main`` as rank `rank` of
    `world` (torchrun's variables, a file store of its own per run), with
    ``ARCH_PRESETS["tiny"] = arch``; saves each run's final trainer
    parameters of this rank to <out_dir>/<i>.rank<r>.pt."""
    from extdm_tpu_torch import config
    from extdm_tpu_torch.eval import valid_dm
    from extdm_tpu_torch.train import train_ae, train_dm

    torch.set_num_threads(RANK_THREADS)
    config.ARCH_PRESETS["tiny"] = arch
    mains = {"train_dm": train_dm, "train_ae": train_ae, "valid_dm": valid_dm}
    for i, (job, argv) in enumerate(runs):
        module = mains[job]
        seen = {}
        loop = getattr(module, "train_loop", None)
        if loop is not None:
            def capture(trainer, *a, _loop=loop, **k):
                seen["trainer"] = trainer
                return _loop(trainer, *a, **k)
            module.train_loop = capture
        try:
            with _rank_env(rank, world):
                module.main(argv + ["--init_method", f"file://{store_dir}/store{i}"])
        finally:
            if loop is not None:
                module.train_loop = loop
        if "trainer" in seen:
            t = seen["trainer"]
            model = t.fd.unet if hasattr(t, "fd") else t.model
            torch.save({n: v.detach().clone() for n, v in model.state_dict().items()},
                       os.path.join(out_dir, f"{i}.rank{rank}.pt"))


# ------------------------------------------------------------------ build
def build_once(rank, world, csrc, build_root, nvcc):
    """``_build.build_all`` with its sources, build root and compiler
    replaced, as every rank of a launch calls it."""
    from pathlib import Path

    from extdm_tpu_torch import _build

    _build.CSRC, _build.BUILD_ROOT = Path(csrc), Path(build_root)
    _build._nvcc = lambda: nvcc
    _build.build_all()
