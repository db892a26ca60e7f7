#!/usr/bin/env python3
"""Kernels 4 and 8 (the grid sample and its backward) by device time, split by kernel name.

    python3 warp_split.py

Runs ``fused_warp.grid_sample`` (kernel 4) and ``fused_warp.grid_sample_bwd``
(kernel 8) on seeded inputs at the shapes of three paths: the KTH sampler
call at batch 4 (bf16; 5 forward launches), the eval sampler call at batch
16 (bf16; 5) and the AE train step at batch 64 (float32; 6 forward, 5
backward). The grids are smooth seeded affine maps of the identity (the
LFAE's flows are convex mixes of affine grids), the images and cotangents
seeded normals. For each shape it prints one JSON line: the device time per
call of every kernel name the wrapper issues (torch.profiler over SPLIT_REPS
calls after two warm-ups, ``resnet_bwd_split.device_split``: the kernel, and
a zero fill or cast where the wrapper issues one), the total, the same with
the L2 cache evicted before each call (a read of L2_FLUSH_BYTES, its own
kernels left out: repeated calls on the same inputs otherwise find them in the
50 MB L2, which flatters the smaller shapes against an HBM bytes bound) and
the wrapper's time by CUDA events (host work included); then one line per
path with the sums over its launches. Run from a checkout's root: it uses
only the two wrappers, which every checkout of the port has, so that two
checkouts' kernels can be compared on one card. Needs one CUDA card.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys

import torch

from resnet_bwd_split import SPLIT_REPS, device_split

# (image (B, H, W, C), grid (Ho, Wo), padding mode, launches per call or step)
SAMPLER = (((440, 32, 32, 3), (32, 32), "zeros", 1), ((80, 64, 64, 67), (64, 64), "zeros", 1),
           ((80, 16, 16, 256), (16, 16), "zeros", 2), ((80, 32, 32, 128), (32, 32), "zeros", 1))
EVAL = tuple(((4 * s[0], *s[1:]), hw, mode, n) for s, hw, mode, n in SAMPLER)
AE_FORWARD = (((704, 32, 32, 3), (32, 32), "zeros", 1), ((64, 64, 64, 67), (64, 64), "zeros", 1),
              ((64, 16, 16, 256), (16, 16), "zeros", 2), ((64, 32, 32, 128), (32, 32), "zeros", 1),
              ((64, 64, 64, 3), (64, 64), "reflection", 1))
# (image, grid (Ho, Wo), mode, per step, image_grad): the K+1 sparse warp needs d_grid only
AE_BACKWARD = (((64, 32, 32, 128), (32, 32), "zeros", 1, True),
               ((64, 16, 16, 256), (16, 16), "zeros", 2, True),
               ((64, 64, 64, 67), (64, 64), "zeros", 1, True),
               ((704, 32, 32, 3), (32, 32), "zeros", 1, False))
L2_FLUSH_BYTES = 256 << 20  # five times the H100's 50 MB L2
PATHS = (("KTH sampler call, batch 4", torch.bfloat16, SAMPLER, ()),
         ("eval sampler call, batch 16", torch.bfloat16, EVAL, ()),
         ("AE step, batch 64", torch.float32, AE_FORWARD, AE_BACKWARD))


def affine_grid(g, n: int, ho: int, wo: int) -> torch.Tensor:
    """(n, ho, wo, 2) smooth grids: the identity of align_corners=True
    through a seeded affine map near the identity, per sample."""
    ys, xs = torch.meshgrid(torch.linspace(-1, 1, ho, device="cuda"),
                            torch.linspace(-1, 1, wo, device="cuda"), indexing="ij")
    ident = torch.stack([xs, ys], -1).reshape(1, ho * wo, 2)
    a = torch.eye(2, device="cuda") + 0.15 * torch.randn((n, 2, 2), generator=g, device="cuda")
    t = 0.1 * torch.randn((n, 1, 2), generator=g, device="cuda")
    return (ident @ a.transpose(1, 2) + t).reshape(n, ho, wo, 2).contiguous()


def call_ms(fn, reps: int = 10) -> float:
    """Median CUDA-event time of fn() after two warm-up calls."""
    fn()
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wrapper_split(fn, kernel: str, drop=frozenset(), tries: int = 3) -> dict:
    """``device_split(fn)`` without the kernel names in `drop`, taken again
    where the profiler recorded no `kernel` (a dropped trace: every call of
    the wrappers launches it)."""
    for _ in range(tries):
        by = {k: v for k, v in device_split(fn).items() if k not in drop}
        if kernel in by:
            return by
    raise RuntimeError(f"warp_split: no {kernel} recorded in {tries} profiles")


def split_lines(card: str, seed: int = 5) -> None:
    from extdm_tpu_torch.ops import fused_warp

    g = torch.Generator(device="cuda").manual_seed(seed)
    flush = torch.zeros(L2_FLUSH_BYTES // 4, device="cuda")
    evict = lambda: flush.view(4096, -1).sum(1)  # noqa: E731  (a read: it leaves clean lines)
    evict_names = set(device_split(evict))
    for path, dtype, forward, backward in PATHS:
        tot = {"forward_device_ms": 0.0, "forward_cold_device_ms": 0.0, "forward_call_ms": 0.0,
               "backward_device_ms": 0.0, "backward_cold_device_ms": 0.0,
               "backward_call_ms": 0.0}
        cases = [(c, "grid_sample") for c in forward] + [(c, "grid_sample_bwd") for c in backward]
        for case, kernel in cases:
            shape, (ho, wo), mode, count = case[:4]
            image = torch.randn(shape, generator=g, device="cuda").to(dtype)
            grid = affine_grid(g, shape[0], ho, wo)
            if kernel == "grid_sample":
                fn = lambda: fused_warp.grid_sample(image, grid, mode)  # noqa: E731
            else:
                cot = torch.randn((shape[0], ho, wo, shape[-1]), generator=g,
                                  device="cuda").to(dtype)
                fn = lambda: fused_warp.grid_sample_bwd(  # noqa: E731
                    cot, image, grid, mode, image_grad=case[4])
            with torch.no_grad():
                by = wrapper_split(fn, f"{kernel}_kernel")
                cold = wrapper_split(lambda: (evict(), fn()), f"{kernel}_kernel", evict_names)
                ms = call_ms(fn)
            if evict_names & set(by):
                raise RuntimeError(f"warp_split: the eviction's kernels {sorted(evict_names)} "
                                   f"share a name with the wrapper's {sorted(by)}")
            dev = sum(v[1] for v in by.values())
            cold_dev = sum(v[1] for v in cold.values())
            line = {"split": f"{kernel} device time by kernel name (ms per call)", "path": path,
                    "shape": list(shape), "grid": [shape[0], ho, wo, 2], "mode": mode,
                    "dtype": str(dtype).replace("torch.", ""), "per_call": count,
                    "device_ms": dev, "cold_device_ms": cold_dev, "call_ms": ms,
                    "by_kernel": by, "by_kernel_cold": cold}
            if kernel == "grid_sample_bwd":
                line["image_grad"] = case[4]
            side = "forward" if kernel == "grid_sample" else "backward"
            tot[f"{side}_device_ms"] += count * dev
            tot[f"{side}_cold_device_ms"] += count * cold_dev
            tot[f"{side}_call_ms"] += count * ms
            line["card"] = card
            print(json.dumps(line), flush=True)
        print(json.dumps({"split": "per call or step", "path": path, **tot,
                          "reps": SPLIT_REPS, "card": card}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("warp_split: no CUDA device is available", file=sys.stderr)
        return 2
    from extdm_tpu_torch import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    _build.build_all()
    split_lines(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
