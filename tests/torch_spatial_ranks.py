"""The rank side of tests/test_torch_spatial.py and
tests/test_torch_spatial_sampler.py: bodies that run in processes spawned by
``torch_parallel_ranks.spawn`` (gloo on the CPU, a file store), one per
rank. Imports no JAX: the test's parent process holds the references and
the inputs, which reach the ranks through a ``torch.save`` file; each rank
saves what it computed on its shard to <out_dir>/rank<r>.pt."""
import os

import torch
import torch.distributed as dist

import torch_parallel_ranks as ranks


# ------------------------------------------------------------ layer cases
def _exchanges(mesh, inp):
    """halo (every edge, and past a neighbour's rows), margin_rows,
    gather_h / slice_h, sum_over_model and moments on the inputs' global
    tensors."""
    x = mesh.slice_h(inp["x"])
    HL = x.shape[2]
    out = {"halo_zero": mesh.halo(x, 2, 1, "zero"), "halo_cyclic": mesh.halo(x, 1, 2, "cyclic"),
           "halo_wide": mesh.halo(x, HL + 1, 0, "zero"), "gathered": mesh.gather_h(x),
           "bf16": mesh.halo(x.bfloat16(), 1, 1, "cyclic"),
           "summed": mesh.sum_over_model(torch.tensor([float(mesh.m + 1)])),
           "halo_clamp": mesh.halo(x, 2, 1, "clamp"),
           "halo_clamp_wide": mesh.halo(x, HL + 1, 1, "clamp"),
           "margin_clamp": mesh.margin_rows(inp["x"], 1, 2, "clamp")}
    mean, m2, n = mesh.moments(mesh.slice_h(inp["stats"]), (1, 2, 3))
    out.update(mean=mean, m2=m2, n=n)
    return out


def _stw(mesh, inp):
    from extdm_tpu_torch.ops.fused_stw import spatial_stw_layer

    out = {}
    for name, c in inp.items():
        out[name] = spatial_stw_layer(mesh.slice_h(c["x"]), *c["params"], shard=mesh, **c["kw"])
    return out


def _stw_module(mesh, inp):
    from extdm_tpu_torch.models.dm.unet3d import PreNormSTW

    layer = PreNormSTW(**inp["kwargs"])
    layer.load_state_dict(inp["state"])
    return {"y": layer(mesh.slice_h(inp["x"]), shard=mesh)}


def _temporal(mesh, inp):
    from extdm_tpu_torch.ops.fused_stw import spatial_temporal_layer

    return {"y": spatial_temporal_layer(mesh.slice_h(inp["x"]), *inp["params"], **inp["kw"])}


def _resnet(mesh, inp):
    from extdm_tpu_torch.models.dm.unet3d import resnet_block_sharded

    return {"y": resnet_block_sharded(mesh.slice_h(inp["x"]), *inp["params"], shard=mesh,
                                      groups=inp["groups"])}


def _modules(mesh, inp):
    """Downsample, Upsample and MotionAdaptor cases from their state dicts."""
    from extdm_tpu_torch.models.dm.adaptor import MotionAdaptor
    from extdm_tpu_torch.models.dm.unet3d import Downsample, Upsample

    out = {}
    classes = {"down": Downsample, "up": Upsample, "adaptor": MotionAdaptor}
    for name, c in inp.items():
        m = classes[c["cls"]](*c["args"])
        m.load_state_dict(c["state"])
        out[name] = m(mesh.slice_h(c["x"]), shard=mesh)
    return out


def _threshold(mesh, inp):
    from extdm_tpu_torch.models.dm.diffusion import dynamic_threshold

    return {"y": dynamic_threshold(mesh.slice_h(inp["x0"]), shard=mesh)}


def _unet(mesh, inp):
    from extdm_tpu_torch.models.dm.unet3d import Unet3D

    out = {}
    for name, c in inp.items():
        unet = Unet3D(**c["kwargs"])
        unet.load_state_dict(c["state"])
        out[name] = unet(mesh.slice_h(c["x"]), c["t"], mesh.slice_h(c["cond"]), c["fea"],
                         shard=mesh)
    return out


LAYER_CASES = {"exchanges": _exchanges, "stw": _stw, "jax_stw": _stw, "stw_module": _stw_module,
               "temporal": _temporal, "resnet": _resnet, "modules": _modules,
               "threshold": _threshold, "unet": _unet}


def layers(rank, world, store, inputs_path, out_dir):
    """Each case of the inputs file (``LAYER_CASES``) on a (1, world) mesh."""
    from extdm_tpu_torch.parallel import make_spatial_mesh

    w = ranks._world(rank, world, store)
    inp = torch.load(inputs_path, weights_only=False)
    mesh = make_spatial_mesh(w, 1, world)
    with torch.no_grad():
        out = {name: LAYER_CASES[name](mesh, case) for name, case in inp.items()}
    out["mesh"] = (mesh.d, mesh.m)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


# ---------------------------------------------------------------- sampler
def _counted(mesh, fn):
    """fn()'s result and the count of its exchanges by kind."""
    mesh.timings = {}
    try:
        res = fn()
        return res, {k: len(v) for k, v in mesh.timings.items()}
    finally:
        mesh.timings = None


def _sampler_runs(fd, mesh, inp):
    """The spatial sampler drawn from a seeded generator (its exchanges
    counted) and given the global x_T."""
    sampler = fd.make_spatial_sampler(mesh)
    drawn, exchanges = _counted(mesh, lambda: sampler(
        torch.Generator().manual_seed(inp["seed"]), inp["cond"]))
    given = sampler(torch.Generator().manual_seed(inp["seed"]), inp["cond"],
                    init_noise=inp["x_T"])
    return {"drawn": drawn, "given": given, "place": (mesh.d, mesh.m), "exchanges": exchanges}


def _unet_exchanges(fd, unet, mesh, inp):
    """The exchanges of one UNet call on this rank's rows of the encoded
    cond video and the global x_T."""
    rows = mesh.rows(inp["cond"].shape[0])
    _, fea, x_cond = fd._encode(inp["cond"][rows])
    t = torch.full((rows.stop - rows.start,), 500)
    return _counted(mesh, lambda: unet(mesh.local(inp["x_T"]), t, mesh.slice_h(x_cond), fea,
                                       shard=mesh))[1]


def samplers(rank, world, store, inputs_path, out_dir):
    """The spatial sampler on each (data, model) mesh of the inputs at
    `world` ranks, drawn from a seeded generator and given the global x_T,
    the exchanges of the drawn call counted; likewise the trajwarp model of
    the inputs' "traj", with the exchanges of one UNet call of it and of
    its adaptor twin (the "twin" config, seeded weights); then each (job,
    argv) of the inputs' ``jobs`` through its ``main``
    (``torch_parallel_ranks.jobs``)."""
    from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusion, FlowDiffusionConfig
    from extdm_tpu_torch.parallel import make_spatial_mesh

    w = ranks._world(rank, world, store)
    inp = torch.load(inputs_path, weights_only=False)
    fd = ranks.dm_fd(inp)
    traj = inp.get("traj")
    if traj is not None:
        traj_fd = ranks.dm_fd(traj)
        twin = FlowDiffusion(FlowDiffusionConfig(flow_params=traj["flow_params"],
                                                 **traj["twin"]), device="cpu").unet
    out = {"traj": {}}
    for data, model in inp["meshes"]:
        mesh = make_spatial_mesh(w, data, model)
        with torch.no_grad():
            out[(data, model)] = _sampler_runs(fd, mesh, inp)
            if traj is not None:
                res = _sampler_runs(traj_fd, mesh, traj)
                res["unet_exchanges"] = _unet_exchanges(traj_fd, traj_fd.unet, mesh, traj)
                res["twin_exchanges"] = _unet_exchanges(traj_fd, twin, mesh, traj)
                out["traj"][(data, model)] = res
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()
    if inp.get("jobs"):
        ranks.jobs(rank, world, out_dir, inp["arch"], inp["jobs"], out_dir)
