"""The loop and flags the two training jobs share (``train/train_dm.py``,
``train/train_ae.py``): the print / checkpoint / shot / validation cadences
of the JAX CLIs (scripts/train_dm.py, scripts/train_ae.py), the in-memory
moving-shapes stores, the validation metrics and the data-parallel world.

Data parallel: launched as several processes (``torchrun --nproc_per_node
N -m extdm_tpu_torch.train.train_dm ...``), a job splits each global batch
of ``--batch_size`` over the most ranks that divide it (``make_data_group``)
and takes the data-parallel step; ranks beyond them wait at the end. Rank 0
writes the logs, shots and checkpoints and runs the validation (the plain
sampler, as scripts/train_dm.py:104-108), the others wait for it at a
barrier; every rank reads a checkpoint it resumes from."""
from __future__ import annotations

import argparse
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from extdm_tpu_torch.parallel.mesh import DataGroup, init_data_group, make_data_group
from extdm_tpu_torch.train.checkpoint import gate_best, select_gate_metric
from extdm_tpu_torch.utils.logger import MetricLogger, StepTimer


def add_common_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", required=True)
    p.add_argument("--root_dir", default=None)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--checkpoint", default="")
    p.add_argument("--set_start", action="store_true")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--valid_every", type=int, default=None,
                   help="validate every N steps (default: the config's update_ckpt_freq; 0: off)")
    p.add_argument("--valid_videos", type=int, default=16)
    p.add_argument("--nan_guard", type=int, default=0,
                   help="skip non-finite updates; raise after N in a row (0: off)")
    p.add_argument("--shard_map", action="store_true",
                   help="data-parallel step over the ranks of the launch (torchrun); a world of "
                        "more than one rank takes it without the flag too, as the JAX CLIs' "
                        "default GSPMD path does")
    p.add_argument("--loader", default="thread", choices=["thread", "process"],
                   help="loader workers: threads, or forked processes that build whole batches "
                        "(the host augmentation on several cores)")
    p.add_argument("--clip_cache_mb", type=int, default=0,
                   help="RAM budget of the HDF5 clip cache, filled before step 0 (0: off)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--init_method", default="env://",
                   help="torch.distributed init method (default: torchrun's environment)")
    p.add_argument("--synthetic_videos", type=int, default=0,
                   help="train and validate on this many moving-shapes videos made in memory "
                        "(each split from its own seed) instead of the config's HDF5 shards")


def default_backend(device) -> str:
    """The collectives of a launch on `device`: nccl on the card (one rank
    a card), gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def data_group(args, batch_size: int) -> DataGroup:
    """Join the launch's world (``--init_method``; a world of one without
    torchrun) and return the data group of the global batch."""
    world = init_data_group(default_backend(args.device), args.device,
                            init_method=args.init_method)
    return make_data_group(batch_size, world)


def finish(group: DataGroup) -> None:
    """Every rank of the world (members of the data group or not) meets
    here, then leaves the process group."""
    if group.world.size > 1:
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()


def synthetic_stores(num_videos: int, train_frames: int, valid_frames: int, image_size: int,
                     seed: int) -> Dict[str, object]:
    """{"train", "valid"}: moving-shapes stores, the train videos from
    RandomState(seed), the valid videos from RandomState(seed + 1)."""
    from extdm_tpu_torch.data import InMemoryVideoStore, make_moving_shapes_video

    stores = {}
    for split, frames, s in (("train", train_frames, seed), ("valid", valid_frames, seed + 1)):
        rng = np.random.RandomState(s)
        stores[split] = InMemoryVideoStore(
            [make_moving_shapes_video(rng, frames, image_size) for _ in range(num_videos)],
            name=f"synthetic-{split}")
    return stores


def video_metrics(fake: torch.Tensor, real: torch.Tensor, i3d, lpips=None) -> Dict[str, float]:
    """The validation dict of the JAX CLIs from (N, T, H, W, 3) videos in [0,
    1]: PSNR and SSIM (means over videos), FVD, LPIPS (unless `lpips` is
    None), and whether the I3D and LPIPS networks are pretrained."""
    from extdm_tpu_torch.metrics import calculate_fvd2, calculate_psnr1, calculate_ssim1

    dev = i3d.device
    f, r = fake.to(dev).permute(0, 1, 4, 2, 3), real.to(dev).permute(0, 1, 4, 2, 3)
    psnr, _ = calculate_psnr1(f, r)
    ssim, _ = calculate_ssim1(f, r)
    fvd = calculate_fvd2(i3d.get_feats(fake), i3d.get_feats(real))
    out = {"valid_fvd": float(fvd), "valid_psnr": float(psnr["psnr"]),
           "valid_ssim": float(ssim["ssim"]), "i3d_pretrained": float(i3d.pretrained)}
    if lpips is not None:
        lp, _ = lpips.calculate_lpips1(fake, real)
        out.update(valid_lpips=float(lp["lpips"]), lpips_pretrained=float(lpips.pretrained))
    return out


@dataclass
class Cadence:
    """When a loop prints, checkpoints, shoots and validates (in steps)."""
    max_steps: int
    start_step: int = 0
    print_freq: int = 1000
    save_freq: int = 5000
    valid_every: int = 0
    img_freq: int = 0
    vid_freq: int = 0

    @classmethod
    def from_train_params(cls, tp: dict, max_steps: int, start_step: int,
                          valid_every: Optional[int], print_freq: int,
                          save_freq: int) -> "Cadence":
        save = tp.get("update_ckpt_freq", save_freq)
        return cls(max_steps=max_steps, start_step=start_step,
                   print_freq=tp.get("print_freq", print_freq), save_freq=save,
                   valid_every=save if valid_every is None else valid_every,
                   img_freq=tp.get("save_img_freq", 0), vid_freq=tp.get("save_vid_freq", 0))


def _first_tensor(aux: Dict[str, torch.Tensor]) -> Optional[torch.Tensor]:
    return next((v for v in aux.values() if torch.is_tensor(v)), None)


def run_loop(loader: Iterable, cadence: Cadence, metrics: MetricLogger, *,
             step_fn: Callable[[int, object], Dict[str, torch.Tensor]],
             save: Callable[[int], str], log_dir: str, prefix: str,
             shots: Optional[Callable[[int, object, bool, bool], None]] = None,
             validate: Optional[Callable[[int], Dict[str, float]]] = None,
             skipped: Optional[Callable[[], int]] = None, digits: int = 5,
             group: Optional[DataGroup] = None) -> int:
    """Steps cadence.start_step .. max_steps - 1 over `loader` (epochs again
    and again), as the JAX CLIs' loops: each step ``step_fn(step, batch)``;
    at print steps a metrics record (the losses, ``skipped`` where the nan
    guard is on, the window's mean batch_time and data_time) and a line; at
    checkpoint steps ``save(updates done)``; the shots; at validation steps
    ``validate(step)``, its record and a gated ``<prefix>_best_<metric>``
    copy of the checkpoint. Checkpoint, shot and validation seconds are
    recorded too and land in no data_time (the timer skips them). A last
    checkpoint at the end; returns the final step. With a data group, rank
    0 alone saves, shoots and validates, and the ranks meet at a barrier
    after each: a rank reads a checkpoint only once it is written."""
    lead = group is None or group.rank == 0

    def barrier():
        if group is not None:
            group.barrier()

    timer = StepTimer()
    step, best = cadence.start_step, float("inf")
    while step < cadence.max_steps:
        batches = 0
        for batch in loader:
            if step >= cadence.max_steps:
                break
            batches += 1
            timer.mark_data()
            aux = step_fn(step, batch)
            timer.mark_step(_first_tensor(aux))
            if step % cadence.print_freq == 0:
                vals = {k: float(v) for k, v in aux.items()}
                if skipped is not None:
                    vals["skipped_nonfinite"] = float(skipped())
                metrics.log(step, **vals, batch_time=timer.batch_time.avg,
                            data_time=timer.data_time.avg)
                timer.reset()  # each record covers the steps since the last one
                print(f"step {step}: " + " ".join(f"{k}={v:.{digits}f}" for k, v in vals.items()))
            # a checkpoint holds the updates done, steps 0..step: a resume
            # (--set_start) goes on at step + 1
            done = step + 1
            if step > 0 and step % cadence.save_freq == 0:
                if lead:
                    t0 = time.perf_counter()
                    save(done)
                    metrics.log(step, ckpt_seconds=time.perf_counter() - t0)
                barrier()
            want_img = bool(cadence.img_freq) and step > 0 and step % cadence.img_freq == 0
            want_vid = bool(cadence.vid_freq) and step > 0 and step % cadence.vid_freq == 0
            if lead and shots is not None and (want_img or want_vid):
                t0 = time.perf_counter()
                shots(step, batch, want_img, want_vid)
                metrics.log(step, shot_seconds=time.perf_counter() - t0, imgshot=want_img,
                            vidshot=want_vid)
            want_valid = validate is not None and cadence.valid_every and step > 0 \
                and step % cadence.valid_every == 0
            if lead and want_valid:
                t0 = time.perf_counter()
                vm = validate(step)
                metrics.log(step, **vm, valid_seconds=time.perf_counter() - t0)
                print(f"valid @ {step}: " + " ".join(f"{k}={v:.4f}" for k, v in vm.items()))
                if not vm["i3d_pretrained"]:
                    print("WARNING: FVD computed with a RANDOM-INIT I3D: the random feature "
                          "space is degenerate (FVD ~0 for every checkpoint), so best-ckpt "
                          "gating falls back to SSIM.")
                sort_val, disp_val, crit = select_gate_metric(vm)
                if sort_val < best:
                    best = sort_val
                    gate_best(save(done), log_dir, disp_val,
                              prefix if crit == "fvd" else f"{prefix}_{crit}")
            if want_valid:
                barrier()
            timer.skip()
            step += 1
        if not batches:
            raise ValueError("the loader gave no batch: fewer items than one batch?")
    if lead:
        save(step)
    barrier()
    print(f"done at step {step}")
    return step


def epoch_of(updates: int, loader) -> int:
    return updates // max(len(loader), 1)


def open_logs(log_dir: str, lead: bool = True):
    """(stdout tee to <log_dir>/train.log, MetricLogger of metrics.jsonl);
    on a rank other than 0 (``lead`` false), os.devnull and a logger that
    records nothing."""
    from extdm_tpu_torch.utils.logger import Logger

    if not lead:
        return open(os.devnull, "w"), MetricLogger(None)
    os.makedirs(log_dir, exist_ok=True)
    return Logger(os.path.join(log_dir, "train.log")), MetricLogger(
        os.path.join(log_dir, "metrics.jsonl"))
