#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Card: prints the card's name and power limit (nvidia-smi).
2. Build: compiles every kernel in extdm_tpu_torch/csrc/ (nvcc, in parallel).
3. Warm-up: builds the KTH sampling model of bench.py at full width in bf16
   (random weights from a seed) and serves one request, recording the
   inputs each kernel wrapper is given on the way.
4. Kernels: at each of those main-path shapes, runs the kernel and its plain
   PyTorch version on the same inputs, checks them against each other in
   bf16 (the whole output, and for the UNet kernels also the part that the
   kernel's products compute) and at one small shape in float32, and times
   kernel, plain version and (grid sample only) the PyTorch library call
   with CUDA events.
5. End to end: sets every launch counter to 0, serves 3 timed requests of
   batch 4 (each ends in torch.cuda.synchronize), checks the launch counts
   per request (180 STW / 91 temporal / 200 resnet / 5 grid-sample layers)
   and the outputs, and compares one float32 Unet3D forward at batch 1 on
   the card (kernels) with the same weights on the CPU (plain versions).

Prints one JSON line per kernel and shape, the end-to-end timings, a summary
line {"kernels": [...]} and, last, {"ok": true, "device": {...}}. Any failed
check raises before the last line. Needs one CUDA card; imports nothing of
JAX.
"""
from __future__ import annotations

import contextlib
import copy
import json
import math
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

BATCH = 4
TIMED_CALLS = 3
# Peak rates of one H100 SXM at 700 W (NVIDIA data sheet): HBM bytes/s and
# dense flop/s by operand type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# Every check is max|kernel - plain| <= rel * max(1, max|plain|).
# bf16: kernel and plain version round intermediates (conv outputs,
# normalised activations, q/k/v, probabilities) to bf16 at different places
# and sum in another order; the differences pass through the following
# products and the residual add, so the outputs may differ by a few bf16
# ulps (2^-8 relative) at the output's scale: rel = 2^-5, 8 ulps.
BF16_REL_TOL = 2.0 ** -5
# The residual (x, and the temporal layer's ChanLN(x)) is most of the
# attention layers' output, so the limit above is set by it. The part the
# kernel's products compute (window or temporal attention, the resnet
# branch) is held besides, relative to its own size:
#   max|kernel - plain| <= BRANCH_REL_TOL * max|plain - residual|: one bf16
#   ulp of the output is up to 9% of the attention branch's max, which sound
#   runs reach; 2^-2 leaves room for 2-3 such ulps.
#   mean|kernel - plain| <= BRANCH_MEAN_REL_TOL * mean|plain - residual|:
#   most outputs agree exactly, and sound runs read at most 0.008 (resnet)
#   and 0.0034 (attention); 2^-6 is twice the largest.
BRANCH_REL_TOL = 2.0 ** -2
BRANCH_MEAN_REL_TOL = 2.0 ** -6
# float32: the same arithmetic summed in another order.
F32_REL_TOL = 1e-4
# float32 Unet3D, card vs CPU: ~50 layers of float32 sums in another order.
UNET_F32_REL_TOL = 1e-3


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_info() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    line = out.stdout.strip().splitlines()[0]
    print(line, flush=True)
    return line


def cuda_ms(fn, reps: int) -> float:
    """Median of `reps` CUDA-event timings of fn() after two warm-up calls."""
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


def check(name: str, got: torch.Tensor, want: torch.Tensor, rel: float,
          residual: torch.Tensor | None = None) -> dict:
    """max|got - want| against rel * max(1, max|want|) and, given the
    residual part of want, against the size of want - residual (see
    BRANCH_REL_TOL)."""
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{name}: non-finite values")
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    res = {"max_abs_err": err, "tol": rel * max(1.0, want.float().abs().max().item())}
    ok = err <= res["tol"]
    if residual is not None:
        branch = (want.float() - residual.float()).abs()
        res.update(branch_max=branch.max().item(), mean_abs_err=diff.mean().item(),
                   branch_mean=branch.mean().item())
        res.update(branch_tol=BRANCH_REL_TOL * res["branch_max"],
                   mean_tol=BRANCH_MEAN_REL_TOL * res["branch_mean"])
        ok = ok and err <= res["branch_tol"] and res["mean_abs_err"] <= res["mean_tol"]
    if not ok:
        raise AssertionError(f"{name}: kernel and plain version differ beyond a limit: {res}")
    return res


# ----------------------------------------------------------------- kernels
def kernel_table():
    """name -> (wrapper, plain, module attributes that call it, key, cost, residual
    part of the output (None: all of it is the kernel's products), source, replaces)."""
    from extdm_tpu_torch.models.dm import unet3d
    from extdm_tpu_torch.models.lfae import generator, pixelwise_flow
    from extdm_tpu_torch.nn.layers import chan_layer_norm
    from extdm_tpu_torch.ops import fused_resnet, fused_stw, fused_warp

    def warp_key(image, grid, padding_mode="zeros"):
        return (tuple(image.shape), tuple(grid.shape), padding_mode)

    def warp_cost(image, grid, padding_mode="zeros"):
        B, Ho, Wo, _ = grid.shape
        out = B * Ho * Wo * image.shape[-1]
        byts = image.numel() * image.element_size() + grid.numel() * 4 + out * image.element_size()
        return byts, 8 * out, torch.float32  # 3 lerps in float32

    def stw_key(x, *a, window, shift, **k):
        return (tuple(x.shape), tuple(window), tuple(shift))

    def stw_cost(x, gamma, w_qkv, w_proj, b_proj, bias, *, window, shift, heads, dim_head, **k):
        # Pad tokens (T=30 pads to 32) are zeros whose q/k/v are 0 and whose
        # outputs are cropped: only the real tokens' products count, each
        # query against the N keys of its window.
        B, T, H, W, C = x.shape
        n, N, hid = x.numel() // C, math.prod(window), heads * dim_head
        flops = 2 * n * C * 3 * hid + 4 * n * N * hid + 2 * n * hid * C
        byts = (2 * x.numel() + w_qkv.numel() + w_proj.numel()) * x.element_size() + bias.numel() * 4
        return byts, flops, x.dtype

    def stw_residual(x, *a, **k):
        return x

    def temporal_key(x, *a, **k):
        return (tuple(x.shape),)

    def temporal_cost(x, g, s, b, w_qkv, w_out, bias, *, heads, dim_head, **k):
        B, T, H, W, C = x.shape
        n, hid = x.numel() // C, heads * dim_head
        flops = 2 * n * C * 3 * hid + 4 * n * T * hid + 2 * n * hid * C
        byts = (2 * x.numel() + w_qkv.numel() + w_out.numel()) * x.element_size() + bias.numel() * 4
        return byts, flops, x.dtype

    def temporal_residual(x, gamma_cln, *a, eps=1e-5, **k):
        return x.float() + chan_layer_norm(x, gamma_cln, eps).float()

    def resnet_key(x, w1, b1, g1s, g1b, film, *a, **k):
        return (tuple(x.shape), w1.shape[0], film is None)

    def resnet_cost(x, w1, b1, g1s, g1b, film, w2, b2, g2s, g2b, wres=None, bres=None, **k):
        B, T, H, W, Cin = x.shape
        P, Cout = B * T * H * W, w1.shape[0]
        flops = 2 * P * 9 * (Cin * Cout + Cout * Cout)
        if wres is not None:
            flops += 2 * P * Cin * Cout
        weights = w1.numel() + w2.numel() + (wres.numel() if wres is not None else 0)
        byts = (x.numel() + P * Cout + weights) * x.element_size()
        return byts, flops, x.dtype

    def resnet_residual(x, w1, b1, g1s, g1b, film, w2, b2, g2s, g2b, wres=None, bres=None, **k):
        if wres is None:
            return x
        return x @ wres.to(x.dtype).flatten(1).t() + bres.to(x.dtype)

    return {
        "grid_sample": dict(
            wrapper=fused_warp.grid_sample, plain=fused_warp.grid_sample_plain,
            sites=[(pixelwise_flow, "grid_sample"), (generator, "grid_sample")],
            key=warp_key, cost=warp_cost, residual=None,
            source="extdm_tpu_torch/csrc/grid_sample.cu",
            replaces="extdm_tpu/ops/pallas_warp.py:195"),
        "stw_layer": dict(
            wrapper=fused_stw.fused_stw_layer, plain=fused_stw.stw_layer_plain,
            sites=[(unet3d, "fused_stw_layer")], key=stw_key, cost=stw_cost,
            residual=stw_residual,
            source="extdm_tpu_torch/csrc/attention.cu", replaces="extdm_tpu/ops/pallas_stw.py:599"),
        "temporal_layer": dict(
            wrapper=fused_stw.fused_temporal_layer, plain=fused_stw.temporal_layer_plain,
            sites=[(unet3d, "fused_temporal_layer")], key=temporal_key, cost=temporal_cost,
            residual=temporal_residual,
            source="extdm_tpu_torch/csrc/attention.cu",
            replaces="extdm_tpu/ops/pallas_stw.py:1631"),
        "resnet_block": dict(
            wrapper=fused_resnet.fused_resnet_block, plain=fused_resnet.resnet_block_plain,
            sites=[(unet3d, "fused_resnet_block")], key=resnet_key, cost=resnet_cost,
            residual=resnet_residual,
            source="extdm_tpu_torch/csrc/resnet.cu",
            replaces="extdm_tpu/ops/pallas_resnet.py:299"),
    }


@contextlib.contextmanager
def recording(table, record):
    """Route every call site through a recorder that keeps the first inputs
    of each distinct shape and counts the calls, then calls the wrapper."""
    saved = []
    for name, k in table.items():
        def make(name=name, k=k):
            def rec(*args, **kwargs):
                entry = record[name].setdefault(k["key"](*args, **kwargs), {"count": 0})
                if entry["count"] == 0:
                    entry["args"] = [a.clone() if torch.is_tensor(a) else a for a in args]
                    entry["kwargs"] = dict(kwargs)
                entry["count"] += 1
                return k["wrapper"](*args, **kwargs)
            return rec
        record[name] = {}
        for mod, attr in k["sites"]:
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, make())
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def f32_cases(dev):
    """One small float32 case per kernel: (name, args, kwargs)."""
    g = torch.Generator(device=dev).manual_seed(7)
    r = lambda *s, scale=1.0: torch.randn(s, generator=g, device=dev) * scale  # noqa: E731
    heads, dh, C = 8, 32, 64
    hid = heads * dh
    return [
        ("grid_sample", [r(2, 16, 16, 67), torch.rand(2, 12, 20, 2, generator=g, device=dev) * 2.4
                         - 1.2], {"padding_mode": "zeros"}),
        ("grid_sample", [r(2, 16, 16, 67), r(2, 12, 20, 2)], {"padding_mode": "border"}),
        ("grid_sample", [r(2, 16, 16, 67), r(2, 12, 20, 2)], {"padding_mode": "reflection"}),
        ("stw_layer", [r(1, 6, 8, 8, C), 1 + r(C, scale=0.1), r(3 * hid, C, scale=C ** -0.5),
                       r(C, hid, scale=hid ** -0.5), r(C, scale=0.1), r(heads, 64, 64, scale=0.1)],
         dict(window=(4, 4, 4), shift=(2, 2, 2), heads=heads, dim_head=dh)),
        ("temporal_layer", [r(1, 30, 4, 4, C), 1 + r(C, scale=0.1), 1 + r(C, scale=0.1),
                            r(C, scale=0.1), r(3 * hid, C, scale=C ** -0.5),
                            r(C, hid, scale=hid ** -0.5), r(heads, 30, 30, scale=0.1)],
         dict(heads=heads, dim_head=dh)),
        ("resnet_block", [r(1, 3, 8, 8, C), r(2 * C, C, 1, 3, 3, scale=(9 * C) ** -0.5),
                          r(2 * C, scale=0.1), 1 + r(2 * C, scale=0.1), r(2 * C, scale=0.1),
                          r(1, 4 * C, scale=0.3), r(2 * C, 2 * C, 1, 3, 3, scale=(18 * C) ** -0.5),
                          r(2 * C, scale=0.1), 1 + r(2 * C, scale=0.1), r(2 * C, scale=0.1),
                          r(2 * C, C, 1, 1, 1, scale=C ** -0.5), r(2 * C, scale=0.1)],
         dict(groups=8)),
    ]


def kernel_phase(table, record, card):
    summary = {}
    for name, k in table.items():
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
                   library_ms=0.0 if name == "grid_sample" else None, max_abs_err=0.0)
        for key, entry in record[name].items():
            args, kwargs, count = entry["args"], entry["kwargs"], entry["count"]
            out_k = k["wrapper"](*args, **kwargs)
            out_p = k["plain"](*args, **kwargs)
            torch.cuda.synchronize()
            residual = k["residual"] and k["residual"](*args, **kwargs)
            res = check(f"{name}{key}", out_k, out_p, BF16_REL_TOL, residual)
            reps = 10
            ms = cuda_ms(lambda: k["wrapper"](*args, **kwargs), reps)
            plain_ms = cuda_ms(lambda: k["plain"](*args, **kwargs), reps)
            byts, flops, op_dtype = k["cost"](*args, **kwargs)
            bytes_ms, ops_ms = byts / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[op_dtype] * 1e3
            line = {"kernel": name, "shape": list(key[0]), "key": str(key[1:]),
                    "dtype": str(args[0].dtype).replace("torch.", ""), "per_call": count,
                    "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": None,
                    "bound_ms": max(bytes_ms, ops_ms),
                    "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", **res}
            if name == "grid_sample":
                image = args[0].permute(0, 3, 1, 2)
                grid = args[1].to(image.dtype)
                mode = kwargs.get("padding_mode", "zeros")
                line["library_ms"] = cuda_ms(lambda: F.grid_sample(
                    image, grid, mode="bilinear", padding_mode=mode, align_corners=True), reps)
                tot["library_ms"] += count * line["library_ms"]
            else:
                line["library_ms_note"] = "no single PyTorch call computes this layer"
            line["card"] = card
            log(line)
            tot["ms"] += count * ms
            tot["plain_ms"] += count * plain_ms
            tot["bound_ms"] += count * line["bound_ms"]
            tot["bytes_ms"] += count * bytes_ms
            tot["ops_ms"] += count * ops_ms
            tot["max_abs_err"] = max(tot["max_abs_err"], res["max_abs_err"])
        summary[name] = tot

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, args, kwargs in f32_cases(torch.device("cuda")):
        k = table[name]
        res = check(f"{name} float32", k["wrapper"](*args, **kwargs), k["plain"](*args, **kwargs),
                    F32_REL_TOL)
        log({"kernel": name, "shape": list(args[0].shape), "dtype": "float32",
             "check": "kernel vs plain", **res})
    return summary


# ----------------------------------------------------------------- end to end
def expected_launches(cfg):
    levels, steps = len(cfg.dim_mults), cfg.sampling_timesteps
    return {"stw_layer": steps * 2 * (2 * levels + 1),
            "temporal_layer": steps * (1 + 2 * levels) + 1,
            "resnet_block": steps * (4 * levels + 4),
            "grid_sample": 5}


def unet_f32_card_vs_cpu(cfg):
    """One float32 Unet3D forward at batch 1: kernels on the card vs plain on the CPU."""
    import dataclasses

    cfg32 = dataclasses.replace(cfg, dtype=None)
    torch.manual_seed(0)
    unet_cpu = cfg32.make_unet().eval().requires_grad_(False)
    unet_gpu = copy.deepcopy(unet_cpu).cuda()
    g = torch.Generator().manual_seed(11)
    tc, tp, h = cfg.cond_frames, cfg.pred_frames, cfg.frame_shape // 2
    hf = cfg.frame_shape // 4
    inputs = [torch.randn(1, tp, h, h, 3, generator=g), torch.tensor([500]),
              torch.randn(1, tc, h, h, 3, generator=g),
              torch.randn(1, tc + tp, hf, hf, cfg.bottleneck_dim, generator=g)]
    with torch.no_grad():
        out_gpu = unet_gpu(*[t.cuda() for t in inputs]).cpu()
        t0 = time.perf_counter()
        out_cpu = unet_cpu(*inputs)
        cpu_s = time.perf_counter() - t0
    res = check("unet3d float32 card vs cpu", out_gpu, out_cpu, UNET_F32_REL_TOL)
    log({"check": "unet3d float32 batch 1, card kernels vs CPU plain", "shape": list(out_cpu.shape),
         "cpu_s": cpu_s, **res})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from extdm_tpu_torch import _build
    from extdm_tpu_torch.config import kth_sampling_config
    from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusion

    t_start = time.perf_counter()
    card = card_info()
    log({"phase": "card", "kind": torch.cuda.get_device_name(0),
         "count": torch.cuda.device_count(), "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    build_dir = _build.build_all()
    log({"phase": "build", "seconds": time.perf_counter() - t0, "dir": str(build_dir)})

    cfg = kth_sampling_config(dtype=torch.bfloat16)
    fd = FlowDiffusion(cfg, device="cuda", seed=0)
    sampler = fd.make_sampler()
    cond = torch.rand((BATCH, cfg.cond_frames, cfg.frame_shape, cfg.frame_shape, 3),
                      generator=torch.Generator().manual_seed(1)).cuda()
    gen = torch.Generator(device="cuda")

    table = kernel_table()
    record = {}
    t0 = time.perf_counter()
    with recording(table, record):
        sampler(gen.manual_seed(1), cond)
        torch.cuda.synchronize()
    log({"phase": "warm-up request", "seconds": time.perf_counter() - t0,
         "shapes": {n: len(r) for n, r in record.items()}})
    want = expected_launches(cfg)
    seen = {n: sum(e["count"] for e in r.values()) for n, r in record.items()}
    if seen != want:
        raise AssertionError(f"warm-up kernel calls {seen} != expected {want}")

    summary = kernel_phase(table, record, card)

    # ---- the main path: counters from 0, three timed requests
    times, launches = [], {}
    for i in range(TIMED_CALLS):
        for k in table.values():
            k["wrapper"].launches = 0
        t0 = time.perf_counter()
        out = sampler(gen.manual_seed(100 + i), cond)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches = {n: k["wrapper"].launches for n, k in table.items()}
        if launches != want:
            raise AssertionError(f"request {i}: kernel launches {launches} != expected {want}")
    B, T, tp = BATCH, cfg.cond_frames + cfg.pred_frames, cfg.pred_frames
    for key, shape in (("sample_out_vid", (B, T, cfg.frame_shape, cfg.frame_shape, 3)),
                       ("sample_warped_vid", (B, T, cfg.frame_shape, cfg.frame_shape, 3)),
                       ("sample_vid_grid", (B, T, cfg.frame_shape // 2, cfg.frame_shape // 2, 2)),
                       ("sample_vid_conf", (B, T, cfg.frame_shape // 2, cfg.frame_shape // 2, 1))):
        if tuple(out[key].shape) != shape or not torch.isfinite(out[key]).all():
            raise AssertionError(f"{key}: shape {tuple(out[key].shape)} (want {shape}) or non-finite")
    med = statistics.median(times)
    log({"phase": "end to end", "config": "KTH 64px tc=10 tp=20 DDIM-10 bf16", "batch": B,
         "ms_per_call": [t * 1e3 for t in times], "median_ms": med * 1e3,
         "predicted_frames_per_s": B * tp / med, "launches_per_call": launches, "card": card})

    unet_f32_card_vs_cpu(cfg)

    kernels = []
    for name, k in table.items():
        s = summary[name]
        kernels.append({"name": name, "route": "cuda", "source": k["source"],
                        "replaces": k["replaces"], "launches": launches[name],
                        "max_abs_err": s["max_abs_err"], "ms": s["ms"], "plain_ms": s["plain_ms"],
                        "bound_ms": s["bound_ms"],
                        "bound_by": "bytes" if s["bytes_ms"] >= s["ops_ms"] else "operations",
                        "library_ms": s["library_ms"]})
    log({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
