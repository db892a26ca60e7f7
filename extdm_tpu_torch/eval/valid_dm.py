"""Stage-2 evaluation (port of scripts/valid_dm.py:41-225).

    python -m extdm_tpu_torch.eval.valid_dm --config configs/DM/kth.yaml \\
        --synthetic_videos 4 --num_sample_video 4 --batch_size 4 --device cpu

Trajectories ride the batch axis (each video repeated ``num_sample_video``
times, ``np.repeat`` order); each batch is rolled out autoregressively in
ceil(pred / tp) sampler calls, each conditioned on the last ``tc``
predicted frames and seeded by its own ``torch.Generator`` (batch, round).
Then the reference protocol: FVD per trajectory (mean / std / 95%
interval), the trajectory nearest each real video by I3D-feature L1
distance and its FVD, best-of-n PSNR, SSIM and LPIPS, and the sampling
rate (the first sampler call excluded, a CUDA sync before each clock read).
The lines go to stdout and ``<log_dir>/metrics.txt``.

Data: ``--root_dir`` (the config's HDF5 shards; needs h5py) or
``--synthetic_videos N`` (moving-shapes videos made in memory from
``--seed``). Weights: ``--flowae_checkpoint`` / ``--checkpoint`` are
``.pth`` files with the reference key names; without the first the LFAE is
a seeded random init (smoke mode), as in the JAX CLI. LPIPS and I3D take
their reference state dicts (``--lpips_state_dict`` / ``--i3d_state_dict``)
or stay seeded random, flagged ``pretrained: False``. Not ported yet: the
comparison gif, ``--dump_flow``, ``--dump_arrays`` and the ``--mesh_*``
multi-device modes.
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
    calculate_psnr2,
    calculate_ssim2,
)

METRICS = ("fvd", "psnr", "ssim", "lpips")


def metric_stuff(values: np.ndarray):
    """mean, std and the 95% interval's half width (Student t)."""
    from scipy import stats

    mean, std = float(np.mean(values)), float(np.std(values))
    conf = std * float(stats.t.ppf((1 + 0.95) / 2.0, len(values) - 1)) / math.sqrt(
        max(len(values), 2))
    return mean, std, conf


def _load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def load_weights(fd, flowae_checkpoint: str = "", checkpoint: str = "") -> None:
    """Stage-1 and diffusion weights into `fd`, as the JAX CLIs load them
    (``scripts/train_dm.py:load_lfae_variables``): a reference AE checkpoint
    ({"region_predictor", "bg_predictor", "generator"} state dicts) or an
    LFAE state dict; a reference DM checkpoint ({"diffusion":
    GaussianDiffusion state dict}, ``denoise_fn.*``) or a Unet3D state dict.
    Without a stage-1 file the LFAE keeps its seeded random init."""
    if not flowae_checkpoint:
        print("WARNING: no --flowae_checkpoint; using random LFAE (smoke mode)")
    else:
        ckpt = _load(flowae_checkpoint)
        parts = ("region_predictor", "bg_predictor", "generator")
        if all(p in ckpt for p in parts):
            ckpt = {f"{p}.{k}": v for p in parts for k, v in ckpt[p].items()}
        fd.lfae.load_state_dict(ckpt)
        print(f"loaded LFAE from {flowae_checkpoint}")
    if checkpoint:
        ckpt = _load(checkpoint)
        if "diffusion" in ckpt:
            ckpt = {k[len("denoise_fn."):]: v for k, v in ckpt["diffusion"].items()
                    if k.startswith("denoise_fn.")}
        fd.unet.load_state_dict(ckpt)
        print(f"loaded diffusion from {checkpoint}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def evaluate(fd, loader: Iterable, *, num_traj: int, total_pred: int, seed: int = 0,
             metrics: Iterable[str] = METRICS, i3d: Optional[I3DExtractor] = None,
             lpips: Optional[LPIPSMetric] = None,
             init_noise: Optional[Callable[[int, int], Optional[torch.Tensor]]] = None) -> Dict:
    """Sample every batch of `loader` (clips in a stored layout, on any
    device) `num_traj` times and score the trajectories. `init_noise(batch,
    round)` may give each sampler call's starting noise. Returns the metric
    ``lines``, their ``values``, the real videos and the samples (float32
    (N, T, H, W, 3) and (N * num_traj, T, H, W, 3) on fd.device), and
    ``seconds``: sampling per call, the metrics and the loader's wait."""
    cfg, dev = fd.cfg, fd.device
    tc, tp = cfg.cond_frames, cfg.pred_frames
    wanted = set(metrics)
    sampler = fd.make_sampler()
    num_autoreg = math.ceil(total_pred / tp)
    real_all, sample_all, call_s, pred_frames = [], [], [], []
    for clips in loader:
        clips = clips[0] if isinstance(clips, (tuple, list)) else clips
        video = canonicalize_clips(torch.as_tensor(clips).to(dev))  # (B, T, H, W, 3)
        video_rep = video.repeat_interleave(num_traj, dim=0)
        b = len(real_all)
        cond, preds = video_rep[:, :tc], []
        for r in range(num_autoreg):
            gen = torch.Generator(device=dev).manual_seed(seed * 1_000_003 + b * 1000 + r)
            noise = init_noise(b, r) if init_noise is not None else None
            _sync(dev)
            t0 = time.perf_counter()
            pred = sampler(gen, cond, init_noise=noise)["sample_out_vid"][:, tc:].float()
            _sync(dev)
            call_s.append(time.perf_counter() - t0)
            pred_frames.append(pred.shape[0] * pred.shape[1])
            preds.append(pred)
            cond = pred[:, -tc:] if pred.shape[1] >= tc else torch.cat(
                [cond[:, pred.shape[1]:], pred], dim=1)
        pred_full = torch.cat(preds, dim=1)[:, :total_pred]
        real_all.append(video)
        sample_all.append(torch.cat([video_rep[:, :tc], pred_full], dim=1))
    if len(call_s) == 1:  # one call: time a warm one for the rate line
        gen = torch.Generator(device=dev).manual_seed(seed * 1_000_003 + 10 ** 6)
        _sync(dev)
        t0 = time.perf_counter()
        sampler(gen, cond, init_noise=init_noise(0, 0) if init_noise is not None else None)
        _sync(dev)
        call_s.append(time.perf_counter() - t0)
        pred_frames.append(pred_frames[0])

    real, samples = torch.cat(real_all), torch.cat(sample_all)
    N = real.shape[0]
    print(f"evaluated {N} videos x {num_traj} trajectories")
    lines, values = [], {}
    seconds = {"sampling_per_call": call_s, "loader_wait": getattr(loader, "wait_s", 0.0)}

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
        fvd_mean, fvd_std, fvd_conf = metric_stuff(np.asarray(fvd_traj))
        values.update(fvd_traj=fvd_traj, fvd_best=fvd_best, i3d_pretrained=i3d.pretrained)
        lines += [f"fvd_traj mean/std/conf95: {fvd_mean:.3f} / {fvd_std:.3f} / {fvd_conf:.3f}",
                  f"fvd_best: {fvd_best:.3f}", f"i3d_pretrained: {i3d.pretrained}"]

    real_rep = real.repeat_interleave(num_traj, dim=0)

    def tchw(v):  # PSNR and SSIM take (B, T, C, H, W)
        return v.permute(0, 1, 4, 2, 3)

    if "psnr" in wanted:
        values["psnr2"] = timed("psnr", lambda: calculate_psnr2(tchw(samples), tchw(real_rep),
                                                                num_traj))
        lines.append(f"psnr2 (best-of-{num_traj}): {values['psnr2']:.3f}")
    if "ssim" in wanted:
        values["ssim2"] = timed("ssim", lambda: calculate_ssim2(tchw(samples), tchw(real_rep),
                                                                num_traj))
        lines.append(f"ssim2 (best-of-{num_traj}): {values['ssim2']:.4f}")
    if "lpips" in wanted:
        lpips = lpips or LPIPSMetric(device=dev)
        values["lpips2"] = timed("lpips", lambda: lpips.calculate_lpips2(samples, real_rep,
                                                                         num_traj))
        values["lpips_pretrained"] = lpips.pretrained
        lines += [f"lpips2 (best-of-{num_traj}): {values['lpips2']:.4f}",
                  f"lpips_pretrained: {lpips.pretrained}"]
    warm_s = sum(call_s[1:])
    values["sampling_frames_per_sec"] = sum(pred_frames[1:]) / warm_s
    lines.append(f"sampling_frames_per_sec: {values['sampling_frames_per_sec']:.2f}")
    return dict(lines=lines, values=values, real=real, samples=samples, seconds=seconds)


def main(argv=None) -> int:
    from extdm_tpu_torch.config import dm_config_from_yaml, load_config
    from extdm_tpu_torch.data import InMemoryVideoStore, make_moving_shapes_video
    from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusion
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
    p.add_argument("--i3d_state_dict", default="", help="pytorch_i3d weights (.pth)")
    p.add_argument("--lpips_state_dict", default="", help="lpips AlexNet weights (.pth)")
    p.add_argument("--metrics", default=",".join(METRICS),
                   help="comma-separated subset of fvd,psnr,ssim,lpips")
    p.add_argument("--stw_window_major", default="0", choices=WINDOW_MAJOR_MODES,
                   help="STW layout: 0 padded windows, 1 window-major, auto by layer shape")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg_raw = load_config(args.config)
    dp = cfg_raw["dataset_params"]
    vp = dp["valid_params"]
    tc, total_pred = vp["cond_frames"], vp["pred_frames"]
    cfg = dm_config_from_yaml(cfg_raw, arch=args.arch, stw_window_major=args.stw_window_major)
    fd = FlowDiffusion(cfg, device=args.device, seed=args.seed)
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
    i3d = (I3DExtractor(_load(args.i3d_state_dict), device=fd.device)
           if args.i3d_state_dict else None)
    lpips = (LPIPSMetric(_load(args.lpips_state_dict), device=fd.device)
             if args.lpips_state_dict else None)
    out = evaluate(fd, loader, num_traj=args.num_sample_video, total_pred=total_pred,
                   seed=args.seed, metrics=args.metrics.split(","), i3d=i3d, lpips=lpips)
    print("\n".join(out["lines"]))
    os.makedirs(args.log_dir, exist_ok=True)
    with open(os.path.join(args.log_dir, "metrics.txt"), "w") as f:
        f.write("\n".join(out["lines"]) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
