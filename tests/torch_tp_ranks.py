"""The rank side of tests/test_torch_tensor_parallel.py: one spawn of 4
gloo ranks on the CPU (``torch_parallel_ranks.spawn``) runs the
tensor-parallel DM step on a (data 2, model 2) mesh, on the hybrid (dcn 2,
data 1, model 2) mesh, and the checkpoint chain tensor parallel -> data
parallel -> tensor parallel. Imports no JAX: the inputs arrive by
``torch.save``; each rank saves what it computed to <out_dir>/rank<r>.pt."""
import os

import torch
import torch.distributed as dist

import torch_parallel_ranks as ranks


def _tp_trainer(inp, mesh):
    from extdm_tpu_torch.train.dm_trainer import DMTrainer, make_optimizer

    fd = ranks.dm_fd(inp)
    return DMTrainer(fd, make_optimizer(fd.unet.parameters(), *inp["opt"]), mesh=mesh)


def _step(trainer, inp, rows):
    """One step on the inputs' rows `rows` with their draws."""
    return trainer.train_step(None, inp["video"][rows], t=inp["t"][rows],
                              noise=inp["noise"][rows])


def _tp_step(inp, mesh):
    """One tensor-parallel step from the inputs' weights: aux, the whole
    state after it, this rank's stored tensors and the UNet's emptied
    ones."""
    from extdm_tpu_torch.parallel import resident_bytes

    trainer = _tp_trainer(inp, mesh)
    mesh.timings = {}
    aux = _step(trainer, inp, mesh.rows(inp["video"].shape[0]))
    counts, mesh.timings = {k: len(v) for k, v in mesh.timings.items()}, None
    tp = trainer.tp
    return {"place": (mesh.d, mesh.m, mesh.dcn), "aux": {k: v.item() for k, v in aux.items()},
            "whole": {k: v.clone() for k, v in tp.state_dict().items()},
            "shards": {n: s.detach().clone() for n, s in tp.shards.items()},
            "replicated": {n: p.detach().clone() for n, p in tp.params.items()
                           if n not in tp.axes},
            "unet_numel": {n: p.numel() for n, p in trainer.fd.unet.named_parameters()},
            "moments": {n: {k: v.shape for k, v in trainer.optimizer.opt.state[p].items()
                            if torch.is_tensor(v)}
                        for n, p in zip(tp.names, trainer.optimizer.params)},
            "resident_bytes": resident_bytes(trainer.optimizer), "exchanges": counts}


def _chain(inp, w):
    """A tensor-parallel step on (2, 2), its payload into a data-parallel
    step over the world, that payload into a tensor-parallel step again;
    the three payloads."""
    from extdm_tpu_torch.parallel import make_data_group, make_spatial_mesh
    from extdm_tpu_torch.train.checkpoint import dm_payload, restore_dm

    B = inp["video"].shape[0]
    mesh = make_spatial_mesh(w, 2, 2)
    tp = _tp_trainer(inp, mesh)
    _step(tp, inp, mesh.rows(B))
    out = [dm_payload(tp.fd.unet, tp.optimizer, 1, B, tp=tp.tp)]

    group = make_data_group(B, w)
    dp = ranks.dm_trainer(inp, group)
    restore_dm(out[0], dp.fd.unet, dp.optimizer)
    _step(dp, inp, group.rows(B))
    out.append(dm_payload(dp.fd.unet, dp.optimizer, 2, 2 * B))

    mesh = make_spatial_mesh(w, 2, 2)
    tp = _tp_trainer(inp, mesh)
    restore_dm(out[1], tp.fd.unet, tp.optimizer, tp=tp.tp)
    _step(tp, inp, mesh.rows(B))
    out.append(dm_payload(tp.fd.unet, tp.optimizer, 3, 3 * B, tp=tp.tp))
    return out


def steps(rank, world, store, inputs_path, out_dir):
    from extdm_tpu_torch.parallel import make_hybrid_mesh, make_spatial_mesh

    w = ranks._world(rank, world, store)
    inp = torch.load(inputs_path, weights_only=False)
    out = {"tp": _tp_step(inp, make_spatial_mesh(w, 2, 2)),
           "hybrid": _tp_step(inp, make_hybrid_mesh(w, 2, 2)),
           "chain": _chain(inp, w)}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()
