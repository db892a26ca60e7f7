#!/usr/bin/env python3
"""The end-to-end metrics of ``chip_smoke.py``, timed alone, on one NVIDIA GPU.

    python3 e2e_ab.py [--calls N]

Run from the root of a checkout: it times the ``extdm_tpu_torch`` beside
it, so that two checkouts (a parent and a change) can be timed in turns on
one card. With the inputs ``chip_smoke.py`` makes from the same seeds, after
one warm-up call or step each, it times N calls or steps (host clock, each
ending in ``torch.cuda.synchronize()``) of:

  kth_sampler_ms     the KTH sampler at batch 4, STW layout "0" (bf16);
  kth_step_ms        the KTH train step at batch 8 (bf16 compute, remat);
  eval_call_ms       the eval sampler call: the KTH sampler at batch 16
                     (4 videos x 4 trajectories) in layout "auto";
  eval_call_l0_ms    the same call in layout "0" (kernel 1 on every window
                     layer): whether the window-major layout pays;
  m1248_sampler_ms   the multi1248/ada sampler at batch 4;
  m1248_step_ms      the multi1248/ada train step at batch 8;
  ae_step_ms         the AE (stage-1) train step at batch 64, float32
                     (configs/AE/kth.yaml, PyTorch's TF32 defaults), on raw
                     uint8 pairs with the KTH flip and jitter on the card, as
                     chip_smoke.py's phase 7 builds it;

and for one more call or step of each the card's busy time (torch.profiler:
the union of the device's kernel and copy intervals, ``busy_ms``) beside
its host-clock time: a call whose busy share is low waits on the host, and
a kernel's gain shows in its busy time before it shows end to end. Prints
the card's name and power limit, then one JSON line. Needs one CUDA card;
imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

BATCH, TRAIN_BATCH, EVAL_BATCH, AE_BATCH = 4, 8, 16, 64


def busy_ms(fn) -> float:
    """The card's busy time over one fn() call: the union of the device
    intervals torch.profiler records."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def timed(fn, calls: int) -> dict:
    """fn() once to warm up, `calls` times on the host clock, once under the
    profiler (host clock and busy time)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    busy = busy_ms(fn)
    profiled = (time.perf_counter() - t0) * 1e3
    return {"ms": times, "median_ms": statistics.median(times), "profiled_call_ms": profiled,
            "busy_ms": busy, "busy_share": busy / profiled}


def sampler_metric(cfg, batch: int, seed: int, calls: int) -> dict:
    from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusion

    fd = FlowDiffusion(cfg, device="cuda", seed=0)
    sampler = fd.make_sampler()
    cond = torch.rand((batch, cfg.cond_frames, cfg.frame_shape, cfg.frame_shape, 3),
                      generator=torch.Generator().manual_seed(seed)).cuda()
    gen = torch.Generator(device="cuda")
    out = timed(lambda: sampler(gen.manual_seed(100), cond), calls)
    del fd, sampler
    torch.cuda.empty_cache()
    return out


def step_metric(cfg, seed: int, calls: int) -> dict:
    from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusion
    from extdm_tpu_torch.train.dm_trainer import DMTrainer, make_optimizer

    fd = FlowDiffusion(cfg, device="cuda", seed=0)
    trainer = DMTrainer(fd, make_optimizer(fd.unet.parameters(), 2e-4, (500000,), 0.5))
    T, px = cfg.cond_frames + cfg.pred_frames, cfg.frame_shape
    video = torch.rand((TRAIN_BATCH, T, px, px, 3),
                       generator=torch.Generator().manual_seed(seed)).cuda()
    gen = torch.Generator(device="cuda")
    out = timed(lambda: trainer.train_step(gen.manual_seed(10), video), calls)
    del trainer, fd
    torch.cuda.empty_cache()
    return out


def ae_step_metric(seed: int, calls: int) -> dict:
    from extdm_tpu_torch.config import kth_ae_training_config
    from extdm_tpu_torch.models.lfae.recon_model import ReconstructionModel
    from extdm_tpu_torch.train.ae_trainer import AETrainer, make_optimizer

    cfg = kth_ae_training_config()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = ReconstructionModel(**cfg["model"])
    trainer = AETrainer(model, make_optimizer(cfg["lr"], cfg["milestones"], cfg["gamma"]),
                        device_augment=cfg["device_augment"], device="cuda")
    px, g = cfg["frame_shape"], torch.Generator().manual_seed(seed)
    batch = {k: torch.randint(0, 256, (AE_BATCH, px, px), generator=g, dtype=torch.uint8).cuda()
             for k in ("source", "driving")}
    gen = torch.Generator(device="cuda")
    out = timed(lambda: trainer.train_step(gen.manual_seed(10), batch), calls)
    del trainer, model, batch
    torch.cuda.empty_cache()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--calls", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("e2e_ab: no CUDA device is available", file=sys.stderr)
        return 2
    from extdm_tpu_torch import _build
    from extdm_tpu_torch.config import (kth_multi1248_config, kth_sampling_config,
                                        kth_training_config)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    bf16 = torch.bfloat16
    line = {
        "kth_sampler_ms": sampler_metric(kth_sampling_config(dtype=bf16), BATCH, 1, args.calls),
        "kth_step_ms": step_metric(kth_training_config(bf16), 2, args.calls),
        "eval_call_ms": sampler_metric(kth_sampling_config(dtype=bf16, stw_window_major="auto"),
                                       EVAL_BATCH, 4, args.calls),
        "eval_call_l0_ms": sampler_metric(kth_sampling_config(dtype=bf16, stw_window_major="0"),
                                          EVAL_BATCH, 4, args.calls),
        "m1248_sampler_ms": sampler_metric(kth_multi1248_config(dtype=bf16), BATCH, 6,
                                           args.calls),
        "m1248_step_ms": step_metric(kth_multi1248_config(dtype=bf16, remat=True), 7, args.calls),
        "ae_step_ms": ae_step_metric(3, args.calls),
    }
    print(json.dumps({"e2e": line, "build_s": build_s, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
