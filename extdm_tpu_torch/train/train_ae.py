"""Stage-1 (LFAE) training job (port of scripts/train_ae.py).

    python -m extdm_tpu_torch.train.train_ae --config configs/AE/kth.yaml \\
        [--device_augment] [--bf16] [--max_steps N] [--log_dir logs/ae_kth] \\
        [--synthetic_videos N] [--device cuda|cpu]
    torchrun --nproc_per_node N -m extdm_tpu_torch.train.train_ae --shard_map ...

Frame pairs (``TwoFramesDataset`` in a ``DatasetRepeater``) train the
``ReconstructionModel`` with Adam(0.5, 0.999) and the MultiStepLR schedule
(``AETrainer``). The pairs are augmented on the host (``data/augmentation.py``,
numpy) or, with ``--device_augment``, shipped as raw uint8 and augmented on
the device (``train/device_augment.py``; flip, jitter, resize, rotation and
crop only). A step's draws come from ``step_generator(root, step)``. The
cadences are the yaml's print_freq, update_ckpt_freq and save_img_freq and
``--valid_every``: ``<log_dir>/train.log``, ``metrics.jsonl``, the rolling
``RegionMM.ckpt``, the region grid ``imgshots/step*.png``, and at each
validation the LFAE's reconstruction of held-out clips (the last cond frame
warped to every frame) with PSNR, SSIM, FVD and LPIPS and a gated
``RegionMM_best_*`` copy. ``--checkpoint <ckpt> --set_start`` resumes the
modules, Adam's moments, the schedule's count, the nan guard's count and the
loss weights. ``--bf16`` trains with the bf16 compute policy
(``ReconstructionModel(dtype=torch.bfloat16)``: parameters and BatchNorm
statistics stay float32); validation reconstructs in float32, as the JAX
CLI's does.

Launched on N ranks (torchrun), the job is data parallel (``train/job.py``):
each rank loads its rows of every global batch of ``--batch_size``, the
step runs under SyncBN and averages losses and gradients over the ranks
(``AETrainer(group=...)``); rank 0 logs, checkpoints, shoots and
validates. A world of one runs as a single process does. Not ported:
``--loader process`` (ROADMAP §1, the rest of the data feed), which raises.
"""
from __future__ import annotations

import argparse
import contextlib
import os
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from extdm_tpu_torch.data import DataLoader, VideoDataset, canonicalize_clips
from extdm_tpu_torch.train.ae_trainer import AETrainer
from extdm_tpu_torch.train.checkpoint import (AE_PARTS, ae_payload, load_checkpoint,
                                              restore_ae, save_checkpoint,
                                              start_step_from_example)
from extdm_tpu_torch.train.job import (Cadence, add_common_flags, data_group, epoch_of,
                                       finish, open_logs, refuse_unported, run_loop,
                                       synthetic_stores, video_metrics)
from extdm_tpu_torch.utils.logger import MetricLogger
from extdm_tpu_torch.utils.seed import step_generator

CKPT = "RegionMM.ckpt"
DEVICE_AUGMENT_KEYS = ("flip_param", "jitter_param", "resize_param", "rotation_param",
                       "crop_param")


def valid_loader(cfg: dict, data, num_videos: int, batch_size: int, seed: int, device,
                 num_workers: int = 4) -> DataLoader:
    """The first ``num_videos`` held-out clips of ``data`` (the config's root
    or a store), tc + tp frames each from the start, in order, as raw uint8
    batches on ``device``."""
    dp = cfg["dataset_params"]
    vp = dp["valid_params"]
    ds = VideoDataset(data, type=vp["type"], total_videos=num_videos,
                      num_frames=vp["cond_frames"] + vp["pred_frames"],
                      image_size=dp["frame_shape"], random_time=False, seed=seed, raw_uint8=True)
    return DataLoader(ds, batch_size, shuffle=False, num_workers=num_workers, drop_last=False,
                      seed=seed, device=device)


def reconstruct_clips(lfae, loader: Iterable, cond_frames: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(real, out_vid, warped_vid), each (N, T, H, W, 3) float32 on the host:
    every clip of ``loader`` canonicalised to [0, 1], and the LFAE's full
    encode of it (``encode_video(with_decode=True)``): its last cond frame
    warped to every frame and decoded."""
    reals, recons, warps = [], [], []
    with torch.no_grad():
        for clips, _ in loader:
            video = canonicalize_clips(clips)
            out = lfae.encode_video(video, cond_frames, with_decode=True)
            reals.append(video.cpu())
            recons.append(out["out_vid"].float().cpu())
            warps.append(out["warped_vid"].float().cpu())
    return torch.cat(reals), torch.cat(recons), torch.cat(warps)


def run_ae_validation(cfg: dict, model, data, num_videos: int, batch_size: int, cache: dict,
                      seed: int = 1234, device="cuda") -> Dict[str, float]:
    """The periodic stage-1 validation (ref scripts/AE/train.py:361-371,
    397-545): ``reconstruct_clips`` of the first ``num_videos`` held-out
    clips (``valid_loader``) by the LFAE in eval mode with the weights of
    `model`'s three modules, then PSNR, SSIM, FVD and LPIPS of the
    reconstructions. `cache` keeps the LFAE, the metric networks and the
    loader across calls."""
    from extdm_tpu_torch.metrics import I3DExtractor, LPIPSMetric
    from extdm_tpu_torch.models.dm.flow_diffusion import LFAE

    device = torch.device(device)
    if "lfae" not in cache:
        cache["lfae"] = LFAE(cfg["flow_params"]["model_params"]).to(device).eval()
        cache.setdefault("i3d", I3DExtractor(device=device))
        cache.setdefault("lpips", LPIPSMetric(device=device))
        cache["loader"] = valid_loader(cfg, data, num_videos, batch_size, seed, device)
    lfae = cache["lfae"]
    restore_ae({part: getattr(model, part).state_dict() for part in AE_PARTS}, lfae)
    real, recon, _ = reconstruct_clips(lfae, cache["loader"],
                                       cfg["dataset_params"]["valid_params"]["cond_frames"])
    return video_metrics(recon, real, cache["i3d"], cache["lpips"])


@contextlib.contextmanager
def frozen_statistics(model: torch.nn.Module):
    """Train-mode forwards whose BatchNorm running statistics are put back
    after (flax's ``mutable=["batch_stats"]`` with the update dropped)."""
    saved = {k: v.clone() for k, v in model.named_buffers()}
    try:
        yield
    finally:
        with torch.no_grad():
            for k, v in model.named_buffers():
                v.copy_(saved[k])


def region_imgshot(trainer: AETrainer, batch: dict):
    """The region grid of the batch's first pair (reference imgshot,
    scripts/AE/train.py:324): a train-mode forward on the canonicalised,
    unaugmented batch (TPS drawn from seed 0), statistics left as they were."""
    from extdm_tpu_torch.models.lfae.transform import random_tps
    from extdm_tpu_torch.train.device_augment import canonicalize_images
    from extdm_tpu_torch.utils.visualize import RegionVisualizer

    model, dev = trainer.model, trainer.device
    src = canonicalize_images(torch.as_tensor(batch["source"]).to(dev))
    drv = canonicalize_images(torch.as_tensor(batch["driving"]).to(dev))
    tps = None
    if model.uses_tps:
        tps = random_tps(torch.Generator(device=dev).manual_seed(0), src.shape[0], device=dev,
                         **model.transform_params)
    with torch.no_grad(), frozen_statistics(model):
        _, generated = model(src, drv, tps)
    keys = ("prediction", "deformed", "occlusion_map", "source_region_params",
            "driving_region_params")
    out = {k: ({kk: vv.float().cpu().numpy() for kk, vv in v.items()} if isinstance(v, dict)
               else v.float().cpu().numpy()) for k, v in generated.items() if k in keys}
    return RegionVisualizer(kp_size=2).visualize(src.cpu().numpy(), drv.cpu().numpy(), out)


def train_loop(trainer: AETrainer, loader: Iterable, cadence: Cadence, log_dir: str, *,
               root: torch.Generator, batch_size: int,
               draws: Optional[Callable[[int], Tuple[object, object]]] = None,
               validate: Optional[Callable[[int], Dict[str, float]]] = None,
               metrics: Optional[MetricLogger] = None) -> int:
    """The job's loop over `loader`'s {source, driving} batches: one
    ``trainer.train_step`` a batch with the step's generator
    ``step_generator(root, step)`` (``draws(step)`` gives the (tps, augment)
    draws in its place), the region imgshot, ``validate(step)`` and the
    checkpoints in `log_dir` (on the data group's rank 0, where the trainer
    has a group). Returns the final step."""
    metrics = metrics or MetricLogger(os.path.join(log_dir, "metrics.jsonl"))

    def step_fn(step, batch):
        tps, augment = draws(step) if draws is not None else (None, None)
        return trainer.train_step(step_generator(root, step), batch, tps=tps, augment=augment)

    def save(done):
        path = os.path.join(log_dir, CKPT)
        save_checkpoint(path, ae_payload(trainer.model, trainer.optimizer, done,
                                         done * batch_size, epoch_of(done, loader),
                                         trainer.loss_weights))
        return path

    def shots(step, batch, want_img, want_vid):
        from extdm_tpu_torch.utils.visualize import save_image

        if want_img:
            save_image(os.path.join(log_dir, "imgshots", f"step{step:07d}.png"),
                       region_imgshot(trainer, batch))

    skipped = (lambda: trainer.optimizer.notfinite_count) if trainer.optimizer.nan_guard else None
    return run_loop(loader, cadence, metrics, step_fn=step_fn, save=save, log_dir=log_dir,
                    prefix="RegionMM", shots=shots, validate=validate, skipped=skipped, digits=4,
                    group=trainer.group)


def main(argv=None) -> int:
    from extdm_tpu_torch.config import load_config

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_flags(p)
    p.add_argument("--log_dir", default="logs/ae")
    p.add_argument("--valid_batch_size", type=int, default=8)
    p.add_argument("--learnable_loss_weights", action="store_true")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute policy (parameters and BatchNorm statistics stay float32)")
    p.add_argument("--device_augment", action="store_true",
                   help="ship raw uint8 pairs and augment them on the device")
    args = p.parse_args(argv)
    refuse_unported(args)

    cfg = load_config(args.config)
    if args.root_dir:
        cfg["dataset_params"]["root_dir"] = args.root_dir
    aug_params = cfg["dataset_params"].get("augmentation_params")
    device_aug = None
    if args.device_augment:
        extra = set(aug_params or ()) - set(DEVICE_AUGMENT_KEYS)
        if extra:
            raise SystemExit(f"--device_augment supports {sorted(DEVICE_AUGMENT_KEYS)}; "
                             f"config also has {sorted(extra)}")
        device_aug = {k: (aug_params or {}).get(k) for k in DEVICE_AUGMENT_KEYS}
    batch_size = args.batch_size or cfg["flow_params"]["train_params"]["batch_size"]
    group = data_group(args, batch_size)
    tee, metrics = open_logs(args.log_dir, lead=group.world.rank == 0)
    with contextlib.closing(tee), contextlib.closing(metrics), contextlib.redirect_stdout(tee):
        if group.member:
            _train(args, cfg, batch_size, device_aug, group, metrics)
        finish(group)
    return 0


def _train(args, cfg: dict, batch_size: int, device_aug: Optional[dict], group,
           metrics: MetricLogger) -> None:
    """The job on a member of the data group."""
    from extdm_tpu_torch.config import ae_model_kwargs
    from extdm_tpu_torch.data import DatasetRepeater, TwoFramesDataset
    from extdm_tpu_torch.models.lfae.recon_model import ReconstructionModel
    from extdm_tpu_torch.train.ae_trainer import make_optimizer
    from extdm_tpu_torch.utils.seed import setup_seed

    dp = cfg["dataset_params"]
    tp = cfg["flow_params"]["train_params"]
    vp = dp["valid_params"]
    aug_params = dp.get("augmentation_params")
    root = setup_seed(args.seed, group.world.device)
    if args.synthetic_videos:
        stores = synthetic_stores(args.synthetic_videos,
                                  max(dp.get("max_frame_distance", 50) + 1, 16),
                                  vp["cond_frames"] + vp["pred_frames"], dp["frame_shape"],
                                  args.seed)
        train_data, valid_data = stores["train"], stores["valid"]
    else:
        train_data = valid_data = dp["root_dir"]
    dataset = TwoFramesDataset(
        train_data, type=dp["train_params"]["type"], frame_shape=dp["frame_shape"],
        min_frame_distance=dp.get("min_frame_distance", 0),
        max_frame_distance=dp.get("max_frame_distance", 50),
        augmentation_params=None if args.device_augment else aug_params, seed=args.seed,
        raw_uint8=args.device_augment)
    dataset = DatasetRepeater(dataset, tp.get("num_repeats", 1))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        model = ReconstructionModel(dtype=torch.bfloat16 if args.bf16 else None,
                                    **ae_model_kwargs(cfg))
    print(f"LFAE parameters: {sum(p.numel() for p in model.parameters()) / 1e6:.2f}M")
    sched = tp["scheduler_param"]
    trainer = AETrainer(model, make_optimizer(tp["lr"], sched["milestones"], sched["gamma"],
                                              nan_guard=args.nan_guard),
                        learnable_loss_weights=args.learnable_loss_weights,
                        device_augment=device_aug, device=group.world.device, group=group)
    loader = DataLoader(dataset, batch_size, num_workers=tp.get("dataloader_workers", 8),
                        seed=args.seed, prefetch=3, device=trainer.device, group=group)
    start_step = 0
    if args.checkpoint:
        ckpt = load_checkpoint(args.checkpoint)
        restore_ae(ckpt, model, trainer.optimizer, trainer.loss_weights)
        if args.set_start:
            start_step = start_step_from_example(ckpt["example"], batch_size)
        print(f"resumed from {args.checkpoint} at step {start_step}")
    cadence = Cadence.from_train_params(
        tp, args.max_steps or tp["max_epochs"] * max(len(loader), 1), start_step,
        args.valid_every, 100, 2500)
    cache: dict = {}

    def validate(step):
        return run_ae_validation(cfg, model, valid_data, args.valid_videos,
                                 args.valid_batch_size, cache, seed=args.seed,
                                 device=trainer.device)

    train_loop(trainer, loader, cadence, args.log_dir, root=root, batch_size=batch_size,
               validate=validate, metrics=metrics)


if __name__ == "__main__":
    raise SystemExit(main())
