"""Stage-2 (diffusion) training job (port of scripts/train_dm.py).

    python -m extdm_tpu_torch.train.train_dm --config configs/DM/kth.yaml \\
        --flowae_checkpoint logs/ae_kth/RegionMM.ckpt [--bf16] [--max_steps N] \\
        [--log_dir logs/dm_kth] [--synthetic_videos N] [--device cuda|cpu]
    torchrun --nproc_per_node N -m extdm_tpu_torch.train.train_dm --shard_map ...

The config's clips (``VideoDataset``, raw uint8, through ``DataLoader`` to
the device) train the UNet with AdamW and the MultiStepLR schedule
(``DMTrainer``), the LFAE frozen. A step's draws come from
``step_generator(root, step)``. The yaml's print_freq, update_ckpt_freq,
save_img_freq and save_vid_freq and ``--valid_every`` set the cadences:
``<log_dir>/train.log`` (the stdout), ``metrics.jsonl``, the rolling
``flowdiff.ckpt``, ``imgshots/*.png`` and ``vidshots/*.gif``, and at each
validation the sampler on held-out clips with PSNR, SSIM, FVD and LPIPS and
a ``flowdiff_best_<fvd>.ckpt`` (with a random I3D: ``flowdiff_ssim_best_<ssim>``)
copy of an improved checkpoint. ``--checkpoint <ckpt> --set_start`` resumes
the UNet, AdamW's moments, the schedule's update count and the nan guard's
count, at the step after the checkpoint's last update.

Data: the config's HDF5 shards (needs h5py), or ``--synthetic_videos N``
moving-shapes videos made in memory. Without ``--flowae_checkpoint`` the
LFAE keeps its seeded random init.

Launched on N ranks (torchrun), the job is data parallel (``train/job.py``):
each rank loads its rows of every global batch of ``--batch_size`` and the
step averages the gradients over the ranks (``DMTrainer(group=...)``);
rank 0 logs, checkpoints, shoots and validates. A world of one runs as a
single process does. Not ported: ``--loader process`` (ROADMAP §1, the
rest of the data feed), which raises.
"""
from __future__ import annotations

import argparse
import contextlib
import os
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from extdm_tpu_torch.data import DataLoader, VideoDataset, canonicalize_clips
from extdm_tpu_torch.train.checkpoint import (dm_payload, load_checkpoint, restore_dm,
                                              save_checkpoint, start_step_from_example)
from extdm_tpu_torch.train.dm_trainer import DMTrainer
from extdm_tpu_torch.train.job import (Cadence, add_common_flags, data_group, epoch_of,
                                       finish, open_logs, refuse_unported, run_loop,
                                       synthetic_stores, video_metrics)
from extdm_tpu_torch.utils.logger import MetricLogger
from extdm_tpu_torch.utils.seed import step_generator

CKPT = "flowdiff.ckpt"


def run_validation(fd, cfg_raw: dict, data, generator: torch.Generator, num_videos: int = 16,
                   batch_size: int = 4, i3d=None, lpips=None, seed: int = 1234) -> Dict[str, float]:
    """The periodic validation (ref scripts/DM/train.py:469-573): the first
    ``num_videos`` held-out clips (``data``: the config's root or a store) in
    order, one sampler call a batch (its generator ``step_generator(generator,
    i)``) on each batch's cond frames, then PSNR, SSIM, FVD and LPIPS of the
    sampled videos against the real ones."""
    from extdm_tpu_torch.metrics import I3DExtractor, LPIPSMetric

    dp = cfg_raw["dataset_params"]
    tc = fd.cfg.cond_frames
    nf = tc + fd.cfg.pred_frames
    ds = VideoDataset(data, type=dp["valid_params"]["type"], total_videos=num_videos,
                      num_frames=nf, image_size=dp["frame_shape"], random_time=False, seed=seed,
                      raw_uint8=True)
    loader = DataLoader(ds, batch_size, shuffle=False, num_workers=4, drop_last=False, seed=seed,
                        device=fd.device)
    sampler = fd.make_sampler()
    reals, fakes = [], []
    for i, (clips, _) in enumerate(loader):
        video = canonicalize_clips(clips)
        out = sampler(step_generator(generator, i), video[:, :tc])
        reals.append(video.cpu())
        fakes.append(out["sample_out_vid"].float().cpu())
    i3d = i3d or I3DExtractor(device=fd.device)
    lpips = lpips or LPIPSMetric(device=fd.device)
    return video_metrics(torch.cat(fakes), torch.cat(reals), i3d, lpips)


def train_loop(trainer: DMTrainer, loader: Iterable, cadence: Cadence, log_dir: str, *,
               root: torch.Generator, batch_size: int,
               draws: Optional[Callable[[int], Tuple[torch.Tensor, torch.Tensor]]] = None,
               validate: Optional[Callable[[int], Dict[str, float]]] = None,
               metrics: Optional[MetricLogger] = None) -> int:
    """The job's loop over `loader`'s (clips, index) batches: one
    ``trainer.train_step`` a batch with the step's generator
    ``step_generator(root, step)`` (``draws(step)`` gives t and noise in their
    place), the shots from ``FlowDiffusion.make_monitor`` on the batch's first
    clip, ``validate(step)`` and the checkpoints in `log_dir` (on the data
    group's rank 0, where the trainer has a group). Returns the final
    step."""
    fd = trainer.fd
    tc, tp = fd.cfg.cond_frames, fd.cfg.pred_frames
    metrics = metrics or MetricLogger(os.path.join(log_dir, "metrics.jsonl"))
    monitor = None

    def step_fn(step, batch):
        t, noise = draws(step) if draws is not None else (None, None)
        return trainer.train_step(step_generator(root, step), batch[0], t=t, noise=noise)

    def save(done):
        path = os.path.join(log_dir, CKPT)
        save_checkpoint(path, dm_payload(fd.unet, trainer.optimizer, done, done * batch_size,
                                         epoch_of(done, loader)))
        return path

    def shots(step, batch, want_img, want_vid):
        from extdm_tpu_torch.utils.visualize import dm_imgshot, dm_vidshot, save_gif, save_image

        nonlocal monitor
        monitor = monitor or fd.make_monitor()
        video = canonicalize_clips(torch.as_tensor(batch[0][:1]).to(fd.device))
        t, noise = draws(step) if draws is not None else (None, None)
        ret = monitor(step_generator(root, step), video,
                      t=None if t is None else t[:1], noise=None if noise is None else noise[:1])
        ret = {k: None if v is None else v.float().cpu().numpy() for k, v in ret.items()}
        video_np = video.cpu().numpy()
        tag = f"B{batch_size:04d}_S{step:06d}"
        if want_img:
            save_image(os.path.join(log_dir, "imgshots", f"{tag}.png"),
                       dm_imgshot(ret, video_np, tc, tp))
        if want_vid:
            save_gif(os.path.join(log_dir, "vidshots", f"{tag}.gif"),
                     dm_vidshot(ret, video_np, tc, tp))

    skipped = (lambda: trainer.optimizer.notfinite_count) if trainer.optimizer.nan_guard else None
    return run_loop(loader, cadence, metrics, step_fn=step_fn, save=save, log_dir=log_dir,
                    prefix="flowdiff", shots=shots, validate=validate, skipped=skipped,
                    group=trainer.group)


def main(argv=None) -> int:
    from extdm_tpu_torch.config import load_config

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_flags(p)
    p.add_argument("--flowae_checkpoint", default="")
    p.add_argument("--arch", default="w_ref_u22/ada_u22")
    p.add_argument("--log_dir", default="logs/dm")
    p.add_argument("--path", type=int, default=0, help="1 -> THW bias variant")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    args = p.parse_args(argv)
    refuse_unported(args)

    cfg_raw = load_config(args.config)
    if args.root_dir:
        cfg_raw["dataset_params"]["root_dir"] = args.root_dir
    batch_size = args.batch_size or cfg_raw["diffusion_params"]["train_params"]["batch_size"]
    group = data_group(args, batch_size)
    tee, metrics = open_logs(args.log_dir, lead=group.world.rank == 0)
    with contextlib.closing(tee), contextlib.closing(metrics), contextlib.redirect_stdout(tee):
        if group.member:
            _train(args, cfg_raw, batch_size, group, metrics)
        finish(group)
    return 0


def _train(args, cfg_raw: dict, batch_size: int, group, metrics: MetricLogger) -> None:
    """The job on a member of the data group."""
    from extdm_tpu_torch.config import dm_config_from_yaml
    from extdm_tpu_torch.eval.valid_dm import load_weights
    from extdm_tpu_torch.metrics import I3DExtractor, LPIPSMetric
    from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusion
    from extdm_tpu_torch.train.dm_trainer import make_optimizer
    from extdm_tpu_torch.utils.seed import setup_seed

    dp = cfg_raw["dataset_params"]
    tp = cfg_raw["diffusion_params"]["train_params"]
    device = group.world.device
    root = setup_seed(args.seed, device)
    cfg = dm_config_from_yaml(cfg_raw, arch=args.arch, path=args.path,
                              dtype=torch.bfloat16 if args.bf16 else None)
    fd = FlowDiffusion(cfg, device=device, seed=args.seed)
    load_weights(fd, args.flowae_checkpoint)
    print(f"UNet parameters: {sum(p.numel() for p in fd.unet.parameters()) / 1e6:.2f}M")
    nf = cfg.cond_frames + cfg.pred_frames
    if args.synthetic_videos:
        stores = synthetic_stores(args.synthetic_videos, nf + 8, nf, dp["frame_shape"],
                                  args.seed)
        train_data, valid_data = stores["train"], stores["valid"]
    else:
        train_data = valid_data = dp["root_dir"]
    dataset = VideoDataset(train_data, type=dp["train_params"]["type"], num_frames=nf,
                           image_size=dp["frame_shape"], seed=args.seed, raw_uint8=True)
    loader = DataLoader(dataset, batch_size, num_workers=tp.get("dataloader_workers", 8),
                        seed=args.seed, prefetch=3, device=fd.device, group=group)
    sched = tp["scheduler_param"]
    trainer = DMTrainer(fd, make_optimizer(fd.unet.parameters(), tp["lr"],
                                           sched["milestones"], sched["gamma"],
                                           nan_guard=args.nan_guard), group=group)
    start_step = 0
    if args.checkpoint:
        ckpt = load_checkpoint(args.checkpoint)
        restore_dm(ckpt, fd.unet, trainer.optimizer)
        if args.set_start:
            start_step = start_step_from_example(ckpt["example"], batch_size)
        print(f"resumed from {args.checkpoint} at step {start_step}")
    cadence = Cadence.from_train_params(tp, args.max_steps or tp["max_epochs"], start_step,
                                        args.valid_every, 1000, 5000)
    nets = {}

    def validate(step):
        if not nets:
            nets.update(i3d=I3DExtractor(device=fd.device), lpips=LPIPSMetric(device=fd.device))
        return run_validation(fd, cfg_raw, valid_data, step_generator(root, 999),
                              num_videos=args.valid_videos, **nets)

    train_loop(trainer, loader, cadence, args.log_dir, root=root, batch_size=batch_size,
               validate=validate, metrics=metrics)


if __name__ == "__main__":
    raise SystemExit(main())
