#!/usr/bin/env python3
"""Kernel 7's device time split by kernel name, beside the decomposed route's.

    python3 resnet_bwd_split.py

Runs ``fused_resnet.resnet_block_bwd`` (kernel 7) and
``resnet_block_bwd_decomposed`` (kernels 10-11 and torch's GroupNorm math)
in bf16 on seeded random blocks at SPLIT_SHAPES: the KTH train step's
largest block, its 16^2 level, its final conv without FiLM, and multi1248's
up level 0 (1024 -> 256 channels). For each it prints one JSON line: the
device time per call of every kernel name (torch.profiler over SPLIT_REPS
calls after two warm-ups), its launches per call and the total. Run from a
checkout's root; it uses only entry points that every checkout of the port
has, so that two checkouts' bodies can be compared on one card. Needs one
CUDA card.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys

import torch

# (B, T, H, W, Cin), Cout, FiLM
SPLIT_SHAPES = (((8, 30, 32, 32, 64), 64, True), ((8, 30, 16, 16, 64), 128, True),
                ((8, 30, 32, 32, 128), 64, False), ((8, 30, 4, 4, 1024), 256, True))
SPLIT_REPS = 5


def device_split(fn, reps: int = SPLIT_REPS) -> dict:
    """kernel name -> [launches, device ms] per fn() call, largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.device_time > 0:
            name = re.match(r"(?:void\s+)?([\w:]+)",
                            e.name.replace("(anonymous namespace)::", "")).group(1)
            n, t = by.get(name, (0, 0.0))
            by[name] = (n + 1, t + e.device_time)
    return {k: [n / reps, t / reps / 1e3]
            for k, (n, t) in sorted(by.items(), key=lambda kv: -kv[1][1])}


def split_lines(card: str, seed: int = 3) -> None:
    """One JSON line per SPLIT_SHAPES block."""
    from extdm_tpu_torch.ops import fused_resnet

    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s, scale=1.0: torch.randn(s, generator=g, device="cuda") * scale  # noqa: E731
    for shape, cout, film in SPLIT_SHAPES:
        B, C = shape[0], shape[-1]
        args = [r(*shape).bfloat16(), r(cout, C, 1, 3, 3, scale=(9 * C) ** -0.5),
                r(cout, scale=0.1), 1 + r(cout, scale=0.1), r(cout, scale=0.1),
                r(B, 2 * cout, scale=0.3) if film else None,
                r(cout, cout, 1, 3, 3, scale=(9 * cout) ** -0.5), r(cout, scale=0.1),
                1 + r(cout, scale=0.1), r(cout, scale=0.1)]
        args += ([r(cout, C, 1, 1, 1, scale=C ** -0.5), r(cout, scale=0.1)] if C != cout
                 else [None, None])
        gg = r(*shape[:-1], cout).bfloat16()
        line = {"split": "resnet backward device time by kernel name (ms per call)",
                "shape": list(shape), "cout": cout, "film": film}
        for name, fn in (("kernel7", fused_resnet.resnet_block_bwd),
                         ("decomposed", fused_resnet.resnet_block_bwd_decomposed)):
            by = device_split(lambda: fn(gg, *args, groups=8))
            line[name] = {"device_ms": sum(v[1] for v in by.values()), "by_kernel": by}
        line["card"] = card
        print(json.dumps(line), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("resnet_bwd_split: no CUDA device is available", file=sys.stderr)
        return 2
    from extdm_tpu_torch import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    _build.build_all()
    split_lines(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
