"""Stage-2 evaluation (port of scripts/valid_dm.py).

    python -m extdm_tpu_torch.eval.valid_dm --config configs/DM/kth.yaml \\
        --synthetic_videos 4 --num_sample_video 4 --batch_size 4 --device cpu
    torchrun --nproc_per_node N -m extdm_tpu_torch.eval.valid_dm --mesh_data N ...
    torchrun --nproc_per_node D*M -m extdm_tpu_torch.eval.valid_dm --mesh_data D \
        --mesh_model M ...

Trajectories ride the batch axis (each video repeated ``num_sample_video``
times, ``np.repeat`` order); each batch is rolled out autoregressively in
ceil(pred / tp) sampler calls, each conditioned on the last ``tc``
predicted frames and seeded by its own ``torch.Generator`` (batch, round).
Then the reference protocol: FVD per trajectory (mean / std / 95%
interval), the trajectory nearest each real video by I3D-feature L1
distance and its FVD, best-of-n PSNR, SSIM and LPIPS, and the sampling
rate (the first sampler call excluded, a CUDA sync before each clock read).
The lines go to stdout and ``<log_dir>/metrics.txt``.

Artefacts, as the JAX CLI writes them: ``sample0.gif`` always (video 0
against its best trajectory, by I3D distance with FVD, else trajectory 0;
blue cond / orange pred borders). ``--dump_arrays``: ``origin.npy`` (the
real videos), ``result.npy`` (trajectory 0 of each) for
``analyze_dumps``; with ``--dump_flow`` also ``result_flows.npy``
(trajectory 0's predicted warp grids of every autoregressive round, cut to
the predicted frames) and ``origin_flows.npy`` (the LFAE's
``encode_video`` flows of the real videos' predicted frames, on the
device in batches of ``--batch_size``). ``--dump_flow``:
``flow_vis/flow_tNNN.png`` and ``conf_tNNN.png``, the first batch's last
sampler call's grid and confidence of row 0.

Data: ``--root_dir`` (the config's HDF5 shards; needs h5py) or
``--synthetic_videos N`` (moving-shapes videos made in memory from
``--seed``). Weights: ``--flowae_checkpoint`` / ``--checkpoint`` are
``.pth`` files with the reference key names; without the first the LFAE is
a seeded random init (smoke mode), as in the JAX CLI (a JAX checkpoint
converts with ``python -m extdm_tpu_torch.convert_checkpoint``). LPIPS and
I3D take their reference state dicts (``--lpips_state_dict`` /
``--i3d_state_dict``) or the JAX package's converted msgpack weights
(``--lpips_params`` / ``--i3d_params``), one of the two for each, or stay
seeded random, flagged ``pretrained: False``.

``--mesh_data N`` (a launch of N ranks, torchrun) shards the (videos x
trajectories) batch axis of every sampler call over the ranks
(``FlowDiffusion.make_sharded_sampler``): each rank samples its rows with
its rank's generator and the batches are gathered; rank 0 computes the
metrics and writes ``metrics.txt``. ``--mesh_model M`` with ``--mesh_data
D`` (a launch of D x M ranks) runs the spatial sampler
(``FlowDiffusion.make_spatial_sampler``): the batch over D data rows, the
latent H over M model ranks. Every rank draws from the same generator per
(batch, round) as a single process, so the metrics are the single
process's. Rank 0 writes every artefact; the files equal a world of
one's.
"""
from __future__ import annotations

import argparse
import math
import os
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from extdm_tpu_torch.data import DataLoader, VideoDataset, canonicalize_clips
from extdm_tpu_torch.metrics import (
    I3DExtractor,
    LPIPSMetric,
    best_trajectory_by_feature_distance,
    calculate_fvd2,
    calculate_psnr3,
    calculate_ssim3,
)
from extdm_tpu_torch.parallel.mesh import DataGroup, World, init_data_group, make_data_group
from extdm_tpu_torch.parallel.spatial import SpatialMesh, make_spatial_mesh
from extdm_tpu_torch.train.checkpoint import AE_PARTS, load_checkpoint, restore_ae, restore_dm
from extdm_tpu_torch.train.job import default_backend, finish
from extdm_tpu_torch.utils.flow_viz import conf2fig, flow2fig
from extdm_tpu_torch.utils.visualize import save_image, visualize_comparison_gif

METRICS = ("fvd", "psnr", "ssim", "lpips")
# Real videos (with their trajectories) per slab moved to the card for PSNR,
# SSIM and LPIPS: at the paper's 100 trajectories x 50 frames of 64^2 x 3, a
# slab of 4 videos' samples is 1 GB in float32 and 2 GB in the metrics'
# float64.
SLAB_VIDEOS = 4


def metric_stuff(values: np.ndarray):
    """mean, std and the 95% interval's half width (Student t)."""
    from scipy import stats

    mean, std = float(np.mean(values)), float(np.std(values))
    conf = std * float(stats.t.ppf((1 + 0.95) / 2.0, len(values) - 1)) / math.sqrt(
        max(len(values), 2))
    return mean, std, conf


def load_lfae(lfae, path: str) -> None:
    """Stage-1 weights from `path` into an ``LFAE``: a reference AE checkpoint
    ({"region_predictor", "bg_predictor", "generator"} state dicts, as the
    AE training job writes it; its other entries are not read) or an LFAE
    state dict. The weights are cast to the LFAE's dtype (a float32 AE
    checkpoint into a bf16 LFAE)."""
    ckpt = load_checkpoint(path)
    if all(p in ckpt for p in AE_PARTS):
        restore_ae(ckpt, lfae)
    else:
        lfae.load_state_dict(ckpt)


def load_weights(fd, flowae_checkpoint: str = "", checkpoint: str = "") -> None:
    """Stage-1 and diffusion weights into `fd`, as the JAX CLIs load them
    (``scripts/train_dm.py:load_lfae_variables``): ``load_lfae``'s stage-1
    files; a reference DM checkpoint ({"diffusion": GaussianDiffusion state
    dict}, ``denoise_fn.*``, as the DM training job writes it) or a Unet3D
    state dict. Without a stage-1 file the LFAE keeps its seeded random init."""
    if not flowae_checkpoint:
        print("WARNING: no --flowae_checkpoint; using random LFAE (smoke mode)")
    else:
        load_lfae(fd.lfae, flowae_checkpoint)
        print(f"loaded LFAE from {flowae_checkpoint}")
    if checkpoint:
        ckpt = load_checkpoint(checkpoint)
        if "diffusion" in ckpt:
            restore_dm(ckpt, fd.unet)
        else:
            fd.unet.load_state_dict(ckpt)
        print(f"loaded diffusion from {checkpoint}")


def load_backbones(device, i3d_state_dict: str = "", i3d_params: str = "",
                   lpips_state_dict: str = "", lpips_params: str = ""):
    """(I3DExtractor or None, LPIPSMetric or None) on `device`: each from a
    reference state dict (``.pth``) or from the JAX package's converted
    weights (flax msgpack), never both; None where neither is given (the
    caller's seeded random network)."""
    from extdm_tpu_torch import convert
    from extdm_tpu_torch.utils.msgpack import load_jax_checkpoint

    def load(name, pth, msgpack, make, to_state_dict):
        if pth and msgpack:
            raise ValueError(f"--{name}_state_dict and --{name}_params both given: pass one")
        if pth:
            return make(load_checkpoint(pth), device=device)
        if msgpack:
            return make(to_state_dict(load_jax_checkpoint(msgpack)), device=device)
        return None

    return (load("i3d", i3d_state_dict, i3d_params, I3DExtractor, convert.i3d_state_dict),
            load("lpips", lpips_state_dict, lpips_params, LPIPSMetric, convert.lpips_state_dict))


@torch.no_grad()
def gt_flows(fd, real: torch.Tensor, cond_frames: int, batch_size: int) -> np.ndarray:
    """The LFAE's ``encode_video`` flows of (N, T, H, W, 3) host videos'
    frames from cond_frames on: (N, T - cond_frames, h, w, 2) float32, the
    encode on fd.device in batches of `batch_size`."""
    out = []
    for i in range(0, real.shape[0], max(1, batch_size)):
        enc = fd.lfae.encode_video(real[i:i + batch_size].to(fd.device), cond_frames)
        out.append(enc["flow"][:, cond_frames:].float().cpu())
    return torch.cat(out).numpy()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _best_of(metric3, samples: torch.Tensor, real: torch.Tensor, num_traj: int, device,
             best) -> float:
    """The best-of-n value of ``calculate_*2`` from the (video, frame)
    matrices of `metric3` (``calculate_psnr3``-like), computed over slabs of
    SLAB_VIDEOS real videos and their trajectories, each moved from host
    memory to `device` in turn: the real videos are repeated one slab at a
    time, never as a whole. `best` is torch.max or torch.min over
    trajectories."""
    rows = []
    for i in range(0, real.shape[0], SLAB_VIDEOS):
        r = real[i:i + SLAB_VIDEOS].to(device)
        s = samples[i * num_traj:(i + r.shape[0]) * num_traj].to(device)
        rows.append(metric3(s, r.repeat_interleave(num_traj, dim=0)))
    per_video = torch.from_numpy(np.concatenate(rows)).mean(dim=1).reshape(-1, num_traj)
    return float(best(per_video, dim=1).values.mean())


def evaluate(fd, loader: Iterable, *, num_traj: int, total_pred: int, seed: int = 0,
             metrics: Iterable[str] = METRICS, i3d: Optional[I3DExtractor] = None,
             lpips: Optional[LPIPSMetric] = None,
             init_noise: Optional[Callable[[int, int], Optional[torch.Tensor]]] = None,
             group: Optional[DataGroup] = None, mesh: Optional[SpatialMesh] = None,
             keep_flows: bool = False) -> Dict:
    """Sample every batch of `loader` (clips in a stored layout, on any
    device) `num_traj` times and score the trajectories. `init_noise(batch,
    round)` may give each sampler call's starting noise. Each finished batch
    goes to host memory; the metrics move SLAB_VIDEOS real videos and their
    trajectories (I3D: its own chunks) to fd.device at a time, so the card
    holds one sampler batch and one slab, whatever the number of videos and
    trajectories. Returns the metric ``lines``, their ``values``, the real
    videos and the samples (float32 (N, T, H, W, 3) and (N * num_traj, T, H,
    W, 3) in host memory), and ``seconds``: sampling per call, the metrics
    and the loader's wait. With a data group of several ranks every rank
    takes part in each (sharded) sampler call and holds the gathered
    samples; rank 0 alone computes the metrics (the others return no
    lines and no values). With a spatial `mesh` the calls run on the
    spatial sampler, every rank holds the samples and rank 0 alone computes
    the metrics likewise. With FVD, ``best_idx`` is each video's trajectory
    nearest it by I3D features (else None). With `keep_flows` it also
    returns, in host memory, ``pred_grids``: trajectory 0's predicted warp
    grids of every round, (N, total_pred, h, w, 2), and ``flow_dump``: the
    first batch's last call's ``sample_vid_grid`` / ``sample_vid_conf`` of
    row 0 (1, tc + tp, h, w, .)."""
    cfg, dev = fd.cfg, fd.device
    tc, tp = cfg.cond_frames, cfg.pred_frames
    wanted = set(metrics)
    sharded = group is not None and group.parallel
    if mesh is not None:
        sampler, lead = fd.make_spatial_sampler(mesh), mesh.world.rank == 0
    elif sharded:
        sampler, lead = fd.make_sharded_sampler(group), group.rank == 0
    else:
        sampler, lead = fd.make_sampler(), True
    num_autoreg = math.ceil(total_pred / tp)
    real_all, sample_all, call_s, pred_frames = [], [], [], []
    grids_all, flow_dump = [], None
    for clips in loader:
        clips = clips[0] if isinstance(clips, (tuple, list)) else clips
        video = canonicalize_clips(torch.as_tensor(clips).to(dev))  # (B, T, H, W, 3)
        video_rep = video.repeat_interleave(num_traj, dim=0)
        b = len(real_all)
        cond, preds, grids = video_rep[:, :tc], [], []
        for r in range(num_autoreg):
            gen = torch.Generator(device=dev).manual_seed(seed * 1_000_003 + b * 1000 + r)
            noise = init_noise(b, r) if init_noise is not None else None
            _sync(dev)
            t0 = time.perf_counter()
            out = sampler(gen, cond, init_noise=noise)
            pred = out["sample_out_vid"][:, tc:].float()
            _sync(dev)
            call_s.append(time.perf_counter() - t0)
            pred_frames.append(pred.shape[0] * pred.shape[1])
            preds.append(pred.cpu())
            if keep_flows:
                grids.append(out["sample_vid_grid"][::num_traj, tc:].float().cpu())
            cond = pred[:, -tc:] if pred.shape[1] >= tc else torch.cat(
                [cond[:, pred.shape[1]:], pred], dim=1)
        pred_full = torch.cat(preds, dim=1)[:, :total_pred]
        if keep_flows:
            grids_all.append(torch.cat(grids, dim=1)[:, :total_pred])
            if flow_dump is None:
                flow_dump = {k: None if out[k] is None else out[k][:1].float().cpu()
                             for k in ("sample_vid_grid", "sample_vid_conf")}
        real_all.append(video.cpu())
        sample_all.append(torch.cat([video_rep[:, :tc].cpu(), pred_full], dim=1))
    if len(call_s) == 1:  # one call: time a warm one for the rate line
        gen = torch.Generator(device=dev).manual_seed(seed * 1_000_003 + 10 ** 6)
        _sync(dev)
        t0 = time.perf_counter()
        sampler(gen, cond, init_noise=init_noise(0, 0) if init_noise is not None else None)
        _sync(dev)
        call_s.append(time.perf_counter() - t0)
        pred_frames.append(pred_frames[0])

    real, samples = torch.cat(real_all), torch.cat(sample_all)
    del real_all, sample_all
    N = real.shape[0]
    print(f"evaluated {N} videos x {num_traj} trajectories")
    lines, values = [], {}
    seconds = {"sampling_per_call": call_s, "loader_wait": getattr(loader, "wait_s", 0.0)}
    result = dict(lines=lines, values=values, real=real, samples=samples, seconds=seconds,
                  best_idx=None, pred_grids=torch.cat(grids_all) if keep_flows else None,
                  flow_dump=flow_dump)
    if not lead:
        return result

    def timed(name, fn):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        seconds[name] = time.perf_counter() - t0
        return out

    if "fvd" in wanted:
        i3d = i3d or I3DExtractor(device=dev)
        real_feats = timed("i3d_real", lambda: i3d.get_feats(real))
        traj_feats = timed("i3d_samples", lambda: i3d.get_feats(samples))

        def fvds():
            per_traj = [calculate_fvd2(traj_feats[i::num_traj], real_feats)
                        for i in range(num_traj)]
            best_idx = best_trajectory_by_feature_distance(real_feats, traj_feats, num_traj)
            best = calculate_fvd2(traj_feats.reshape(N, num_traj, -1)[np.arange(N), best_idx],
                                  real_feats)
            return per_traj, best

        fvd_traj, fvd_best = timed("frechet", fvds)
        result["best_idx"] = best_trajectory_by_feature_distance(real_feats, traj_feats,
                                                                 num_traj)
        fvd_mean, fvd_std, fvd_conf = metric_stuff(np.asarray(fvd_traj))
        values.update(fvd_traj=fvd_traj, fvd_best=fvd_best, i3d_pretrained=i3d.pretrained)
        lines += [f"fvd_traj mean/std/conf95: {fvd_mean:.3f} / {fvd_std:.3f} / {fvd_conf:.3f}",
                  f"fvd_best: {fvd_best:.3f}", f"i3d_pretrained: {i3d.pretrained}"]

    def tchw(fn):  # PSNR and SSIM take (B, T, C, H, W)
        return lambda s, r: fn(s.permute(0, 1, 4, 2, 3), r.permute(0, 1, 4, 2, 3))

    def best_of(fn, best):
        return _best_of(fn, samples, real, num_traj, dev, best)

    if "psnr" in wanted:
        values["psnr2"] = timed("psnr", lambda: best_of(tchw(calculate_psnr3), torch.max))
        lines.append(f"psnr2 (best-of-{num_traj}): {values['psnr2']:.3f}")
    if "ssim" in wanted:
        values["ssim2"] = timed("ssim", lambda: best_of(tchw(calculate_ssim3), torch.max))
        lines.append(f"ssim2 (best-of-{num_traj}): {values['ssim2']:.4f}")
    if "lpips" in wanted:
        lpips = lpips or LPIPSMetric(device=dev)
        values["lpips2"] = timed("lpips", lambda: best_of(lpips.calculate_lpips3, torch.min))
        values["lpips_pretrained"] = lpips.pretrained
        lines += [f"lpips2 (best-of-{num_traj}): {values['lpips2']:.4f}",
                  f"lpips_pretrained: {lpips.pretrained}"]
    warm_s = sum(call_s[1:])
    values["sampling_frames_per_sec"] = sum(pred_frames[1:]) / warm_s
    lines.append(f"sampling_frames_per_sec: {values['sampling_frames_per_sec']:.2f}")
    return result


def main(argv=None) -> int:
    from extdm_tpu_torch.ops.fused_stw import WINDOW_MAJOR_MODES

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", default="")
    p.add_argument("--flowae_checkpoint", default="")
    p.add_argument("--arch", default="w_ref_u22/ada_u22")
    p.add_argument("--root_dir", default=None)
    p.add_argument("--synthetic_videos", type=int, default=0,
                   help="evaluate on this many moving-shapes videos made in memory")
    p.add_argument("--log_dir", default="logs/dm_valid")
    p.add_argument("--num_sample_video", type=int, default=4)
    p.add_argument("--total_videos", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--seed", type=int, default=1234)
    add_backbone_flags(p)
    p.add_argument("--metrics", default=",".join(METRICS),
                   help="comma-separated subset of fvd,psnr,ssim,lpips")
    p.add_argument("--dump_flow", action="store_true",
                   help="save the predicted flow / conf pictures (flow_vis/), and with "
                        "--dump_arrays the flow arrays")
    p.add_argument("--dump_arrays", action="store_true",
                   help="save origin / result (+ flows, with --dump_flow) arrays for "
                        "analyze_dumps")
    p.add_argument("--stw_window_major", default="0", choices=WINDOW_MAJOR_MODES,
                   help="STW layout: 0 padded windows, 1 window-major, auto by layer shape")
    p.add_argument("--device", default="cuda")
    p.add_argument("--mesh_data", type=int, default=1,
                   help="shard the (videos x trajectories) batch axis over this many ranks "
                        "(a launch of that many, torchrun; batch_size * num_sample_video must "
                        "divide by it)")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="shard the latent H axis of the denoiser over this many ranks (a launch "
                        "of mesh_data x mesh_model, torchrun)")
    p.add_argument("--init_method", default="env://",
                   help="torch.distributed init method (default: torchrun's environment)")
    args = p.parse_args(argv)
    world = init_data_group(default_backend(args.device), args.device,
                            init_method=args.init_method)
    group, mesh = _eval_group(args, world)
    if group.member:
        _evaluate(args, group, mesh)
    finish(group)
    return 0


def add_backbone_flags(p: argparse.ArgumentParser) -> None:
    """--i3d_state_dict / --lpips_state_dict (reference .pth) and --i3d_params /
    --lpips_params (the JAX package's converted msgpack weights)."""
    p.add_argument("--i3d_state_dict", default="", help="pytorch_i3d weights (.pth)")
    p.add_argument("--lpips_state_dict", default="", help="lpips AlexNet weights (.pth)")
    p.add_argument("--i3d_params", default="", help="converted I3D weights (JAX msgpack)")
    p.add_argument("--lpips_params", default="",
                   help="converted LPIPS-AlexNet weights (JAX msgpack)")


def _eval_group(args, world: World):
    """(the data group of ``--mesh_data`` ranks, None), or with
    ``--mesh_model`` > 1 (a group of the whole world, the spatial mesh):
    the launch's world (one process without torchrun) must have mesh_data
    x mesh_model ranks."""
    D, M = args.mesh_data, args.mesh_model
    if world.size != D * M:
        raise ValueError(f"--mesh_data {D} x --mesh_model {M} in a launch of {world.size} "
                         f"process(es): launch {D * M} (torchrun --nproc_per_node)")
    rows = args.batch_size * args.num_sample_video
    if rows % D:
        raise ValueError(f"batch_size x num_sample_video = {rows} does not divide over "
                         f"--mesh_data {D}")
    if M == 1:
        return make_data_group(rows, world), None
    print(f"spatial-parallel eval: batch over {D} x latent-H over {M} devices")
    return DataGroup(size=world.size, rank=world.rank, world=world), make_spatial_mesh(world, D, M)


def _evaluate(args, group: DataGroup, mesh: Optional[SpatialMesh] = None) -> None:
    """The evaluation on a rank of the data group (or of the spatial mesh);
    rank 0 writes the lines."""
    from extdm_tpu_torch.config import dm_config_from_yaml, load_config
    from extdm_tpu_torch.data import InMemoryVideoStore, make_moving_shapes_video
    from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusion

    cfg_raw = load_config(args.config)
    dp = cfg_raw["dataset_params"]
    vp = dp["valid_params"]
    tc, total_pred = vp["cond_frames"], vp["pred_frames"]
    cfg = dm_config_from_yaml(cfg_raw, arch=args.arch, stw_window_major=args.stw_window_major)
    fd = FlowDiffusion(cfg, device=group.world.device, seed=args.seed)
    load_weights(fd, args.flowae_checkpoint, args.checkpoint)
    print(f"autoregressive rounds: {math.ceil(total_pred / cfg.pred_frames)} x "
          f"{cfg.pred_frames} frames")

    total_videos = args.total_videos or vp.get("total_videos", 256)
    if args.synthetic_videos:
        rng = np.random.RandomState(args.seed)
        data = InMemoryVideoStore([make_moving_shapes_video(rng, tc + total_pred, dp["frame_shape"])
                                   for _ in range(args.synthetic_videos)], name="synthetic")
        total_videos = min(total_videos, args.synthetic_videos)
    else:
        data = args.root_dir or dp["root_dir"]
    dataset = VideoDataset(data, type=vp["type"], total_videos=total_videos,
                           num_frames=tc + total_pred, image_size=dp["frame_shape"],
                           random_time=False, seed=args.seed, raw_uint8=True)
    loader = DataLoader(dataset, args.batch_size, shuffle=False, num_workers=8,
                        drop_last=False, seed=args.seed, device=fd.device)
    i3d, lpips = load_backbones(fd.device, args.i3d_state_dict, args.i3d_params,
                                args.lpips_state_dict, args.lpips_params)
    out = evaluate(fd, loader, num_traj=args.num_sample_video, total_pred=total_pred,
                   seed=args.seed, metrics=args.metrics.split(","), i3d=i3d, lpips=lpips,
                   group=group, mesh=mesh, keep_flows=args.dump_flow)
    if group.rank != 0:
        return
    print("\n".join(out["lines"]))
    os.makedirs(args.log_dir, exist_ok=True)
    with open(os.path.join(args.log_dir, "metrics.txt"), "w") as f:
        f.write("\n".join(out["lines"]) + "\n")
    write_artefacts(args, fd, out, tc)


def write_artefacts(args, fd, out: Dict, tc: int) -> Dict[str, float]:
    """sample0.gif, and the --dump_arrays / --dump_flow files, in args.log_dir;
    returns the seconds of each part (the arrays' include the GT flows')."""
    real, samples = out["real"].numpy(), out["samples"].numpy()
    N, n_traj = real.shape[0], args.num_sample_video
    traj = samples.reshape(N, n_traj, *samples.shape[1:])
    best = 0 if out["best_idx"] is None else int(out["best_idx"][0])
    t0 = time.perf_counter()
    visualize_comparison_gif(os.path.join(args.log_dir, "sample0.gif"), real[0], traj[0, best],
                             tc)
    seconds = {"gif": time.perf_counter() - t0}
    if args.dump_arrays:
        t0 = time.perf_counter()
        np.save(os.path.join(args.log_dir, "origin.npy"), real)
        np.save(os.path.join(args.log_dir, "result.npy"), traj[:, 0])
        if args.dump_flow:
            t1 = time.perf_counter()
            flows = gt_flows(fd, out["real"], tc, args.batch_size)
            seconds["gt_flows"] = time.perf_counter() - t1
            np.save(os.path.join(args.log_dir, "origin_flows.npy"), flows)
            np.save(os.path.join(args.log_dir, "result_flows.npy"), out["pred_grids"].numpy())
        seconds["arrays"] = time.perf_counter() - t0
        print(f"analysis arrays -> {args.log_dir}")
    if args.dump_flow:
        t0 = time.perf_counter()
        fdir = os.path.join(args.log_dir, "flow_vis")
        grid, conf = out["flow_dump"]["sample_vid_grid"], out["flow_dump"]["sample_vid_conf"]
        for t in range(grid.shape[1]):
            save_image(os.path.join(fdir, f"flow_t{t:03d}.png"), flow2fig(grid[0, t].numpy()))
            if conf is not None:
                save_image(os.path.join(fdir, f"conf_t{t:03d}.png"), conf2fig(conf[0, t].numpy()))
        seconds["flow_pngs"] = time.perf_counter() - t0
        print(f"flow/conf visualizations -> {fdir}")
    print("artefact seconds: " + " ".join(f"{k}={v:.3f}" for k, v in seconds.items()))
    return seconds


if __name__ == "__main__":
    raise SystemExit(main())
