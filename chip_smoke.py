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
6. Training: builds bench.py's KTH train-step configuration (float32 master
   weights, bf16 compute, remat) at batch 8 and takes one warm-up step,
   recording the inputs and incoming cotangent of each backward kernel at
   every distinct shape; checks each backward kernel against its plain
   version (the autograd of the plain forward) there in bf16 and at one small
   shape in float32, and times both; takes 3 timed steps with the counters
   from 0 (18 STW / 10 temporal / 20 resnet layers forward and backward, 1
   grid sample per step); and compares one float32 loss and every UNet
   gradient at batch 1, kernels on the card against the plain versions on
   the CPU.
7. Stage-1 (AE) training: builds configs/AE/kth.yaml's ReconstructionModel
   at full width (float32, seeded init, random VGG19) and AETrainer with the
   KTH flip + jitter device augmentation, takes one warm-up step on raw
   uint8 gray pairs at batch 64, recording the inputs and incoming cotangent
   of every grid-sample backward; checks the grid-sample backward kernel
   against its plain version there in float32 and, at the decode shapes
   (C >= 67), in bf16, and times kernel, plain version and ATen's
   grid_sampler_2d_backward; takes 3 timed steps with the counters from 0 (6
   grid-sample forward and 5 backward launches per step); and compares one
   float32 loss and every gradient at batch 2, kernels on the card against
   the plain versions on the CPU, with the same weights, augmentation and
   TPS draws; one more step runs under torch.profiler for the card's busy
   share and the ops that take its time.
8. Evaluation: the KTH sampling configuration in bf16 with the STW layout
   in "auto" (window-major on the two unshifted 32x32 layers: kernel 9);
   4 in-memory 64 px gray moving-shapes videos of 50 frames through the
   port's VideoDataset and DataLoader (raw uint8, pinned, canonicalised on
   the card), 4 trajectories each (sampler batch 16), 2 autoregressive
   rounds of 20 frames. A recorded warm-up call gives kernel 9's inputs:
   kernel 9 is checked against its plain version and against kernel 1 on
   the same layers (bf16), at a shifted shape with its expanded masks (mode
   "1") and at one float32 shape, and timed beside kernel 1. Then the
   counters go to 0 and ``evaluate`` runs (20 kernel-9 and 160 kernel-1
   launches per sampler call), with PSNR, SSIM, LPIPS and FVD from random
   networks; PSNR, SSIM, LPIPS and I3D features on the card are checked
   against the port's CPU versions on the same videos.

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
TRAIN_BATCH = 8
TIMED_STEPS = 3
AE_BATCH = 64  # the first float32 batch bench_train.py --stage ae recorded
AE_CPU_BATCH = 2
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
# Backward kernels in bf16, each gradient against the plain backward's:
#   max|kernel - plain| <= BWD_MAX_REL_TOL * max|plain| and
#   mean|kernel - plain| <= BWD_MEAN_REL_TOL * mean|plain|.
# The plain backward rounds every product's output (dq/dk/dv, dO, dS, the
# conv gradients) to bf16 and the kernels sum in float32, so they differ by
# bf16 rounding carried through sums with cancellation. Sound runs read at
# most 0.77% of max|plain| (max error) and 0.32% of mean|plain| (mean error)
# at the KTH training shapes: 2^-5 (3.1%) leaves four times the first, 2^-6
# (1.6%) five times the second, and a dropped or halved term moves a gradient
# by far more.
BWD_MAX_REL_TOL = 2.0 ** -5
BWD_MEAN_REL_TOL = 2.0 ** -6
# float32 train step at batch 1, card kernels vs CPU plain versions, TF32
# off: forward and backward through ~60 layers summed in other orders; each
# UNet gradient to this fraction of its own max, the loss relatively.
TRAIN_F32_REL_TOL = 1e-3
# float32 AE step at batch 2, card kernels vs CPU plain versions, TF32 off:
# the losses to AE_LOSS_REL_TOL relatively. The gradients are rough at the
# model's init: train-mode BatchNorm scales near-dead channels up by as much
# as 1/sqrt(eps) = 316, so moving the input frames by one part in 10^7 (a
# float32 rounding) moves some gradients by ~1% of their max (measured on
# the CPU; the JAX package's float32 gradients lie as far from its float64
# ones). So each card gradient must lie within AE_GRAD_REL_TOL of its max
# plus AE_ROUGH_MULT times how far the CPU's own gradient moves under that
# perturbation, plus AE_GRAD_FLOOR of the largest gradient: float32 noise
# at the scale of the whole gradient, for tensors whose own gradient is
# tiny (a conv bias in front of a BatchNorm has a gradient that is 0 in
# exact arithmetic; a deep VGG bias's, 0.2% of the largest, differed by 3%
# of its own max between card and CPU). A gradient lost on the card (as
# when the warps had no backward) moves by ~100% and fails.
AE_LOSS_REL_TOL = 1e-5
AE_GRAD_REL_TOL = 1e-3
AE_ROUGH_MULT = 2.0
AE_ROUGH_EPS = 1e-7
AE_GRAD_FLOOR = 1e-4
EVAL_VIDEOS, EVAL_TRAJ, EVAL_FRAMES = 4, 4, 50  # tc 10 + 40 predicted frames
# Metrics, card vs CPU on the same videos, TF32 off: PSNR and SSIM are
# float64 (summed in another order): 1e-9 absolute. LPIPS and the I3D
# features are float32 networks (5 and ~60 layers) whose convolutions sum
# in another order: LPIPS 1e-4 absolute (distances ~0.1), I3D 1e-3 of the
# features' max.
METRIC_F64_TOL = 1e-9
LPIPS_F32_TOL = 1e-4
I3D_F32_REL_TOL = 1e-3


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
    from extdm_tpu_torch.models.lfae import generator, pixelwise_flow, transform
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

    def stw_plain(*args, window_major="0", **kwargs):
        # the UNet's calls carry their layout mode; the plain version
        # computes the same function in either layout
        return fused_stw.stw_layer_plain(*args, **kwargs)

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
            sites=[(pixelwise_flow, "grid_sample"), (generator, "grid_sample"),
                   (transform, "grid_sample")],
            key=warp_key, cost=warp_cost, residual=None,
            source="extdm_tpu_torch/csrc/grid_sample.cu",
            replaces="extdm_tpu/ops/pallas_warp.py:195"),
        "stw_layer": dict(
            wrapper=fused_stw.fused_stw_layer, plain=stw_plain,
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


def backward_table(forward):
    """name -> the backward kernels' entries, in the layout of kernel_table:
    wrapper and plain take (cotangent, *forward args); sites are where the
    autograd Functions call the wrapper."""
    from extdm_tpu_torch.ops import fused_resnet, fused_stw

    def bwd(fn):  # a forward helper applied to the args after the cotangent
        return lambda g, *a, **k: fn(*a, **k)

    def grad_cost(name):
        fwd_cost = forward[name]["cost"]

        def cost(g, x, *a, **k):
            # only the inputs: one recompute of the forward's products and
            # two products (input and weight gradients) per forward product;
            # bytes: x, g and dx once each, the weights and their float32
            # gradients, and the bias table and its gradient.
            byts, flops, dtype = fwd_cost(x, *a, **k)
            weights = [t for t in a if torch.is_tensor(t) and t.ndim >= 2]
            extra = x.numel() * x.element_size() + sum(t.numel() * 4 for t in weights)
            return byts + extra, 3 * flops, dtype
        return cost

    entries = {
        "stw_layer_bwd": (fused_stw.stw_layer_bwd, fused_stw.stw_layer_plain_vjp, fused_stw,
                          "stw_layer", "extdm_tpu_torch/csrc/attention_bwd.cu",
                          "extdm_tpu/ops/pallas_stw.py:1123"),
        "temporal_layer_bwd": (fused_stw.temporal_layer_bwd, fused_stw.temporal_layer_plain_vjp,
                               fused_stw, "temporal_layer", "extdm_tpu_torch/csrc/attention_bwd.cu",
                               "extdm_tpu/ops/pallas_stw.py:2013"),
        "resnet_block_bwd": (fused_resnet.resnet_block_bwd, fused_resnet.resnet_block_plain_vjp,
                             fused_resnet, "resnet_block", "extdm_tpu_torch/csrc/resnet.cu",
                             "extdm_tpu/ops/pallas_resnet.py:594"),
    }
    return {name: dict(wrapper=wrapper, plain=plain, sites=[(mod, name)],
                       key=bwd(forward[fwd]["key"]), cost=grad_cost(fwd), source=source,
                       replaces=replaces)
            for name, (wrapper, plain, mod, fwd, source, replaces) in entries.items()}


def check_grads(name: str, got, want, max_rel: float, mean_rel: float | None = None) -> dict:
    """Each gradient of got against want: max|got - want| <= max_rel *
    max|want| (with mean_rel: also mean|got - want| <= mean_rel * mean|want|),
    or, without mean_rel, max error <= max_rel * max(1, max|want|).
    Returns the worst ratios."""
    worst = {"max_abs_err": 0.0, "max_ratio": 0.0, "mean_ratio": 0.0}
    for i, (a, b) in enumerate(zip(got, want)):
        if a is None or b is None:
            if (a is None) != (b is None):
                raise AssertionError(f"{name} gradient {i}: present in one version only")
            continue
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{name} gradient {i}: {a.dtype}{tuple(a.shape)} vs "
                                 f"{b.dtype}{tuple(b.shape)}")
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"{name} gradient {i}: non-finite values")
        diff = (a.float() - b.float()).abs()
        err, size = diff.max().item(), b.float().abs().max().item()
        if mean_rel is None:
            ok, ratio, mean_ratio = err <= max_rel * max(1.0, size), err / max(1.0, size), 0.0
        else:
            mean_ratio = diff.mean().item() / max(b.float().abs().mean().item(), 1e-30)
            ratio = err / max(size, 1e-30)
            ok = ratio <= max_rel and mean_ratio <= mean_rel
        if not ok:
            raise AssertionError(f"{name} gradient {i} {tuple(a.shape)}: kernel and plain "
                                 f"backward differ beyond a limit: max error {err} (ratio "
                                 f"{ratio}), mean ratio {mean_ratio}")
        worst = {"max_abs_err": max(worst["max_abs_err"], err),
                 "max_ratio": max(worst["max_ratio"], ratio),
                 "mean_ratio": max(worst["mean_ratio"], mean_ratio)}
    return worst


class Recorder:
    """Stands in for a wrapper at a call site: keeps the first inputs of each
    distinct shape, counts the calls, then calls the wrapper. Its `launches`
    is the wrapper's own counter, which the wrapper may update through the
    name this recorder replaces."""

    def __init__(self, k, entries):
        self.k, self.entries = k, entries

    @property
    def launches(self):
        return self.k["wrapper"].launches

    @launches.setter
    def launches(self, value):
        self.k["wrapper"].launches = value

    def __call__(self, *args, **kwargs):
        entry = self.entries.setdefault(self.k["key"](*args, **kwargs), {"count": 0})
        if entry["count"] == 0:
            entry["args"] = [a.clone() if torch.is_tensor(a) else a for a in args]
            entry["kwargs"] = dict(kwargs)
        entry["count"] += 1
        return self.k["wrapper"](*args, **kwargs)


@contextlib.contextmanager
def recording(table, record):
    """Route every call site through a Recorder."""
    saved = []
    for name, k in table.items():
        record[name] = {}
        for mod, attr in k["sites"]:
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, Recorder(k, record[name]))
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


def backward_phase(table, record, card):
    """Backward kernels vs their plain versions at every recorded training
    shape (bf16) and at one small shape in float32; CUDA-event times."""
    summary = {}
    for name, k in table.items():
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
                   library_ms=None, max_abs_err=0.0)
        for key, entry in record[name].items():
            args, kwargs, count = entry["args"], entry["kwargs"], entry["count"]
            got = k["wrapper"](*args, **kwargs)
            want = k["plain"](*args, **kwargs)
            torch.cuda.synchronize()
            res = check_grads(f"{name}{key}", got, want, BWD_MAX_REL_TOL, BWD_MEAN_REL_TOL)
            ms = cuda_ms(lambda: k["wrapper"](*args, **kwargs), 5)
            plain_ms = cuda_ms(lambda: k["plain"](*args, **kwargs), 5)
            byts, flops, op_dtype = k["cost"](*args, **kwargs)
            bytes_ms, ops_ms = byts / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[op_dtype] * 1e3
            log({"kernel": name, "shape": list(key[0]), "key": str(key[1:]),
                 "dtype": str(args[1].dtype).replace("torch.", ""), "per_step": count,
                 "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": None,
                 "library_ms_note": "no single PyTorch call computes this layer's gradients",
                 "bound_ms": max(bytes_ms, ops_ms),
                 "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", **res,
                 "card": card})
            tot["ms"] += count * ms
            tot["plain_ms"] += count * plain_ms
            tot["bound_ms"] += count * max(bytes_ms, ops_ms)
            tot["bytes_ms"] += count * bytes_ms
            tot["ops_ms"] += count * ops_ms
            tot["max_abs_err"] = max(tot["max_abs_err"], res["max_abs_err"])
        summary[name] = tot

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    fwd_names = {"stw_layer": "stw_layer_bwd", "temporal_layer": "temporal_layer_bwd",
                 "resnet_block": "resnet_block_bwd"}
    for fwd, args, kwargs in f32_cases(dev):
        if fwd not in fwd_names:
            continue
        name = fwd_names[fwd]
        k = table[name]
        x = args[0]
        out_shape = x.shape[:-1] + args[1].shape[:1] if fwd == "resnet_block" else x.shape
        g = torch.randn(out_shape, generator=gen, device=dev)
        res = check_grads(f"{name} float32", k["wrapper"](g, *args, **kwargs),
                          k["plain"](g, *args, **kwargs), F32_REL_TOL)
        log({"kernel": name, "shape": list(args[0].shape), "dtype": "float32",
             "check": "kernel vs plain backward", **res})
    return summary


def expected_train_launches(cfg):
    levels = len(cfg.dim_mults)
    per_layer = {"stw_layer": 2 * (2 * levels + 1), "temporal_layer": 2 + 2 * levels,
                 "resnet_block": 4 * levels + 4}
    fwd = dict(per_layer, grid_sample=1)
    bwd = {f"{n}_bwd": c for n, c in per_layer.items()}
    return fwd, bwd


def train_f32_card_vs_cpu(cfg):
    """One float32 loss and backward at batch 1 with the same weights, t and
    noise: kernels on the card against the plain versions on the CPU."""
    import dataclasses

    from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusion

    cfg32 = dataclasses.replace(cfg, dtype=None)
    g = torch.Generator().manual_seed(12)
    T, px = cfg.cond_frames + cfg.pred_frames, cfg.frame_shape
    video = torch.rand((1, T, px, px, 3), generator=g)
    t = torch.tensor([417])
    noise = torch.randn((1, cfg.pred_frames, px // 2, px // 2, 3), generator=g)
    results = {}
    for device in ("cuda", "cpu"):
        fd = FlowDiffusion(cfg32, device=device, seed=3)
        t0 = time.perf_counter()
        loss, _ = fd.loss(None, video, t=t, noise=noise)
        loss.backward()
        if device == "cuda":
            torch.cuda.synchronize()
        results[device] = (loss.detach().cpu(), {n: p.grad.cpu() for n, p in fd.unet.named_parameters()},
                           time.perf_counter() - t0)
        del fd
    (loss_gpu, grads_gpu, _), (loss_cpu, grads_cpu, cpu_s) = results["cuda"], results["cpu"]
    loss_err = abs(loss_gpu.item() - loss_cpu.item()) / abs(loss_cpu.item())
    if not loss_err <= TRAIN_F32_REL_TOL:
        raise AssertionError(f"float32 loss card {loss_gpu.item()} vs cpu {loss_cpu.item()}")
    worst, worst_name = 0.0, None
    for name, want in grads_cpu.items():
        got = grads_gpu[name]
        if not torch.isfinite(got).all():
            raise AssertionError(f"float32 gradient {name}: non-finite on the card")
        ratio = (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)
        if ratio > worst:
            worst, worst_name = ratio, name
        if ratio > TRAIN_F32_REL_TOL:
            raise AssertionError(f"float32 gradient {name}: card vs cpu max error {ratio} of its max")
    log({"check": "train step float32 batch 1, card kernels vs CPU plain", "loss_card": loss_gpu.item(),
         "loss_cpu": loss_cpu.item(), "loss_rel_err": loss_err, "gradients": len(grads_cpu),
         "worst_grad_rel_err": worst, "worst_grad": worst_name, "tol": TRAIN_F32_REL_TOL,
         "cpu_s": cpu_s})


def train_phase(table, btable, card, others=None):
    """The DM train step at full width: warm-up with recording, backward
    kernel checks, timed steps with launch counts (`others`: further
    kernels, which the step must not launch), float32 card vs CPU."""
    from extdm_tpu_torch.config import kth_training_config
    from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusion
    from extdm_tpu_torch.train.dm_trainer import DMTrainer, make_optimizer

    cfg = kth_training_config(torch.bfloat16)
    fd = FlowDiffusion(cfg, device="cuda", seed=0)
    trainer = DMTrainer(fd, make_optimizer(fd.unet.parameters(), 2e-4, (500000,), 0.5))
    T, px = cfg.cond_frames + cfg.pred_frames, cfg.frame_shape
    video = torch.rand((TRAIN_BATCH, T, px, px, 3), generator=torch.Generator().manual_seed(2)).cuda()
    gen = torch.Generator(device="cuda")

    record, frecord = {}, {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with recording(table, frecord), recording(btable, record):
        aux = trainer.train_step(gen.manual_seed(0), video)
        torch.cuda.synchronize()
    log({"phase": "train warm-up step", "seconds": time.perf_counter() - t0,
         "loss": aux["loss"].item(), "grad_norm": aux["grad_norm"].item(),
         "shapes": {n: len(r) for n, r in record.items()}})
    want_fwd, want_bwd = expected_train_launches(cfg)
    seen = {n: sum(e["count"] for e in r.values()) for n, r in record.items()}
    if seen != want_bwd:
        raise AssertionError(f"warm-up backward kernel calls {seen} != expected {want_bwd}")

    summary = backward_phase(btable, record, card)
    del record
    fwd_ms = 0.0  # forward kernels per step at the training shapes (timed only)
    with torch.no_grad():
        for name, entries in frecord.items():
            for entry in entries.values():
                fwd_ms += entry["count"] * cuda_ms(
                    lambda: table[name]["wrapper"](*entry["args"], **entry["kwargs"]), 5)
    del frecord

    counters = {n: k["wrapper"] for n, k in {**table, **btable, **(others or {})}.items()}
    want_others = {n: 0 for n in others or {}}
    times = []
    for i in range(TIMED_STEPS):
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        aux = trainer.train_step(gen.manual_seed(10 + i), video)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches = {n: fn.launches for n, fn in counters.items()}
        loss, grad_norm = aux["loss"].item(), aux["grad_norm"].item()
        if not (math.isfinite(loss) and math.isfinite(grad_norm)):
            raise AssertionError(f"train step {i}: loss {loss}, grad_norm {grad_norm}")
        if launches != {**want_fwd, **want_bwd, **want_others}:
            raise AssertionError(f"train step {i}: launches {launches} != expected "
                                 f"{ {**want_fwd, **want_bwd, **want_others} }")
        log({"phase": "train step", "step": i, "ms": times[-1] * 1e3, "loss": loss,
             "grad_norm": grad_norm})
    med = statistics.median(times)
    bwd_ms = sum(s["ms"] for s in summary.values())
    log({"phase": "train end to end", "config": "KTH 64px tc=10 tp=20 bf16 compute, float32 "
         "master weights, remat", "batch": TRAIN_BATCH, "ms_per_step": [t * 1e3 for t in times],
         "median_ms": med * 1e3, "train_frames_per_s": TRAIN_BATCH * T / med,
         "launches_per_step": launches, "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
         "forward_kernels_ms": fwd_ms, "backward_kernels_ms": bwd_ms,
         "rest_ms_by_difference": med * 1e3 - fwd_ms - bwd_ms, "card": card})
    del trainer, fd
    torch.cuda.empty_cache()
    train_f32_card_vs_cpu(cfg)
    return summary, launches


# ------------------------------------------------------------- AE training
WARP_MODES = ("zeros", "border", "reflection")


def ae_backward_table():
    """The grid-sample backward kernel in the layout of kernel_table: wrapper
    and plain take (cotangent, image, grid, padding_mode, image_grad,
    grid_grad); the site is where the autograd Function calls the wrapper."""
    from extdm_tpu_torch.ops import fused_warp

    def plain(g, image, grid, padding_mode="zeros", image_grad=True, grid_grad=True):
        d = fused_warp.grid_sample_plain_vjp(g, image, grid, padding_mode)
        return tuple(t if want else None for t, want in zip(d, (image_grad, grid_grad)))

    def key(g, image, grid, padding_mode="zeros", image_grad=True, grid_grad=True):
        return (tuple(image.shape), tuple(grid.shape), padding_mode, image_grad, grid_grad)

    def cost(g, image, grid, padding_mode="zeros", image_grad=True, grid_grad=True):
        # dout and grid read; the image read only for d_grid; d_image and
        # d_grid written once. Per (pixel, channel): 4 weighted scatters
        # (8 flops) for d_image, two differences of lerps (10) for d_grid.
        byts = g.numel() * g.element_size() + grid.numel() * 4
        flops_per = 0
        if image_grad:
            byts += image.numel() * image.element_size()
            flops_per += 8
        if grid_grad:
            byts += image.numel() * image.element_size() + grid.numel() * grid.element_size()
            flops_per += 10
        return byts, flops_per * g.numel(), torch.float32

    return {"grid_sample_bwd": dict(
        wrapper=fused_warp.grid_sample_bwd, plain=plain, sites=[(fused_warp, "grid_sample_bwd")],
        key=key, cost=cost, source="extdm_tpu_torch/csrc/grid_sample.cu",
        replaces="extdm_tpu/ops/pallas_warp.py:356")}


def warp_bwd_library(g, image, grid, padding_mode="zeros", image_grad=True, grid_grad=True):
    """ATen's grid-sample backward on NCHW-contiguous operands (made outside
    the timed call): the one PyTorch call that computes the same gradients."""
    g_nchw = g.permute(0, 3, 1, 2).contiguous()
    img_nchw = image.permute(0, 3, 1, 2).contiguous()
    mode = WARP_MODES.index(padding_mode)
    return lambda: torch.ops.aten.grid_sampler_2d_backward(
        g_nchw, img_nchw, grid, 0, mode, True, [image_grad, grid_grad])


def ae_backward_phase(btable, record, card):
    """The grid-sample backward kernel against its plain version at every
    recorded AE-step shape (float32, and bf16 at the decode shapes), CUDA-event
    times of kernel, plain version and ATen's call."""
    name, k = "grid_sample_bwd", btable["grid_sample_bwd"]
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
               max_abs_err=0.0)
    for key, entry in record[name].items():
        args, kwargs, count = entry["args"], entry["kwargs"], entry["count"]
        got = k["wrapper"](*args, **kwargs)
        want = k["plain"](*args, **kwargs)
        torch.cuda.synchronize()
        # relative to each gradient's own size: at batch 64 the decode warps'
        # d_image is ~1e-5, far under the max(1, .) floor of F32_REL_TOL
        res = check_grads(f"{name}{key}", got, want, F32_REL_TOL, F32_REL_TOL)
        line = {"kernel": name, "shape": list(key[0]), "key": str(key[1:]), "dtype": "float32",
                "per_step": count, **res}
        if args[1].shape[-1] >= 67:  # the decode warps: the kernel serves bf16 images too
            g16, img16 = args[0].bfloat16(), args[1].bfloat16()
            res16 = check_grads(f"{name}{key} bf16", k["wrapper"](g16, img16, *args[2:], **kwargs),
                                k["plain"](g16, img16, *args[2:], **kwargs),
                                BWD_MAX_REL_TOL, BWD_MEAN_REL_TOL)
            line["bf16"] = res16
        ms = cuda_ms(lambda: k["wrapper"](*args, **kwargs), 5)
        plain_ms = cuda_ms(lambda: k["plain"](*args, **kwargs), 5)
        library_ms = cuda_ms(warp_bwd_library(*args, **kwargs), 5)
        byts, flops, op_dtype = k["cost"](*args, **kwargs)
        bytes_ms, ops_ms = byts / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[op_dtype] * 1e3
        line.update(kernel_ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                    library_call="aten.grid_sampler_2d_backward (NCHW-contiguous operands)",
                    bound_ms=max(bytes_ms, ops_ms),
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations", card=card)
        log(line)
        for field, value in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", library_ms),
                             ("bound_ms", max(bytes_ms, ops_ms)), ("bytes_ms", bytes_ms),
                             ("ops_ms", ops_ms)):
            tot[field] += count * value
        tot["max_abs_err"] = max(tot["max_abs_err"], res["max_abs_err"])
    # the padding modes the AE step does not differentiate through, float32
    gen = torch.Generator(device="cuda").manual_seed(9)
    for mode in WARP_MODES:
        image = torch.randn((2, 12, 16, 67), generator=gen, device="cuda")
        grid = torch.rand((2, 10, 14, 2), generator=gen, device="cuda") * 2.4 - 1.2
        g = torch.randn((2, 10, 14, 67), generator=gen, device="cuda")
        res = check_grads(f"{name} {mode} float32", k["wrapper"](g, image, grid, mode),
                          k["plain"](g, image, grid, mode), F32_REL_TOL, F32_REL_TOL)
        log({"kernel": name, "shape": list(image.shape), "padding_mode": mode, "dtype": "float32",
             "check": "kernel vs plain backward", **res})
    return {name: tot}


def grad_fn_check():
    """On a CUDA tensor that needs a gradient, grid_sample's result has a
    grad_fn whose backward launches the backward kernel once."""
    from extdm_tpu_torch.ops import fused_warp

    gen = torch.Generator(device="cuda").manual_seed(5)
    image = torch.randn((2, 16, 16, 67), generator=gen, device="cuda", requires_grad=True)
    grid = (torch.rand((2, 16, 16, 2), generator=gen, device="cuda") * 2.2 - 1.1).requires_grad_()
    out = fused_warp.grid_sample(image, grid)
    if type(out.grad_fn).__name__ != "_GridSampleBackward":
        raise AssertionError(f"grid_sample on CUDA: grad_fn {out.grad_fn}")
    before = fused_warp.grid_sample_bwd.launches
    g = torch.randn(out.shape, generator=gen, device="cuda")
    out.backward(g)
    if fused_warp.grid_sample_bwd.launches != before + 1:
        raise AssertionError("grid_sample's backward did not launch the backward kernel")
    want = fused_warp.grid_sample_plain_vjp(g, image.detach(), grid.detach())
    res = check_grads("grid_sample autograd", (image.grad, grid.grad), want, F32_REL_TOL)
    log({"check": "grid_sample autograd on CUDA: grad_fn _GridSampleBackward, backward = "
         "grid_sample_bwd kernel", **res})


def ae_model_and_trainer(cfg, device, seed=0):
    from extdm_tpu_torch.models.lfae.recon_model import ReconstructionModel
    from extdm_tpu_torch.train.ae_trainer import AETrainer, make_optimizer

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = ReconstructionModel(**cfg["model"])
    return AETrainer(model, make_optimizer(cfg["lr"], cfg["milestones"], cfg["gamma"]),
                     device_augment=cfg["device_augment"], device=device)


def smooth_frames(g, n, px, sigma=4.0):
    """n seeded (px, px) uint8 gray frames of blurred noise: smooth like
    video, so that a warp's gradient is not dominated by pixel-to-pixel
    noise."""
    r = int(3 * sigma)
    k = torch.exp(-0.5 * (torch.arange(-r, r + 1) / sigma) ** 2)
    k = k / k.sum()
    x = torch.rand((n, 1, px, px), generator=g)
    x = F.conv2d(F.pad(x, (r, r, 0, 0), mode="circular"), k.view(1, 1, 1, -1))
    x = F.conv2d(F.pad(x, (0, 0, r, r), mode="circular"), k.view(1, 1, -1, 1))
    lo, hi = x.amin((2, 3), keepdim=True), x.amax((2, 3), keepdim=True)
    return ((x - lo) / (hi - lo) * 255).round()[:, 0].to(torch.uint8)


def ae_f32_card_vs_cpu(cfg):
    """One float32 loss and backward at batch 2 with the same weights,
    augmentation parameters and TPS draw (drawn on the CPU): kernels on the
    card against the plain versions on the CPU, TF32 off; and the CPU once
    more on frames moved by one part in 10^7, to measure how rough the
    gradients are here (see AE_ROUGH_MULT)."""
    from extdm_tpu_torch.models.lfae.transform import random_tps
    from extdm_tpu_torch.train.device_augment import prepare_batch, sample_augment

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(13)
    px = cfg["frame_shape"]
    frames = smooth_frames(g, 2 * AE_CPU_BATCH, px)
    batch = {"source": frames[:AE_CPU_BATCH], "driving": frames[AE_CPU_BATCH:]}
    augment = sample_augment(g, AE_CPU_BATCH, (px, px), **cfg["device_augment"])
    tps = random_tps(g, AE_CPU_BATCH, **cfg["model"]["transform_params"])
    moved = {k: v * (1 + AE_ROUGH_EPS * torch.randn(v.shape, generator=g))
             for k, v in zip(("source", "driving"),
                             prepare_batch(batch["source"], batch["driving"], augment))}
    results = {}
    # the moved frames are augmented already: that run's trainer augments nothing
    runs = (("card", "cuda", batch, augment, cfg), ("cpu", "cpu", batch, augment, cfg),
            ("cpu moved", "cpu", moved, None, dict(cfg, device_augment=None)))
    for run, device, inputs, aug, run_cfg in runs:
        trainer = ae_model_and_trainer(run_cfg, device, seed=4)
        t0 = time.perf_counter()
        total, losses = trainer.loss(None, inputs, tps=tps, augment=aug)
        total.backward()
        if device == "cuda":
            torch.cuda.synchronize()
        results[run] = ({k: v.item() for k, v in losses.items()} | {"total": total.item()},
                        {n: (p.grad if p.grad is not None else torch.zeros_like(p)).cpu()
                         for n, p in trainer.model.named_parameters()},
                        time.perf_counter() - t0)
        del trainer
    (loss_gpu, grads_gpu, _), (loss_cpu, grads_cpu, cpu_s) = results["card"], results["cpu"]
    grads_moved = results["cpu moved"][1]
    for name, want in loss_cpu.items():
        if not abs(loss_gpu[name] - want) <= AE_LOSS_REL_TOL * abs(want):
            raise AssertionError(f"float32 AE loss {name}: card {loss_gpu[name]} vs cpu {want}")
    worst, worst_name, plain_worst, zero, failed = 0.0, None, 0.0, [], []
    floor = AE_GRAD_FLOOR * max(g.abs().max().item() for g in grads_cpu.values())
    for name, want in grads_cpu.items():
        got = grads_gpu[name]
        if not torch.isfinite(got).all():
            raise AssertionError(f"float32 AE gradient {name}: non-finite on the card")
        size = want.abs().max().item()
        if size == 0.0:
            zero.append(name)
        err = (got - want).abs().max().item()
        rough = (grads_moved[name] - want).abs().max().item()
        tol = AE_GRAD_REL_TOL * size + AE_ROUGH_MULT * rough + floor
        if err / max(tol, 1e-30) > worst:
            worst, worst_name = err / max(tol, 1e-30), name
        plain_worst = max(plain_worst, err / max(size, 1e-30))
        if err > tol:
            failed.append(f"{name}: max error {err}, limit {tol} ({AE_GRAD_REL_TOL} of max {size} "
                          f"+ {AE_ROUGH_MULT} x roughness {rough} + floor {floor})")
    if failed:
        raise AssertionError(f"float32 AE gradients, card vs cpu, {len(failed)} beyond their "
                             f"limits: " + "; ".join(failed[:8]))
    log({"check": "AE step float32 batch 2, card kernels vs CPU plain", "loss_card": loss_gpu,
         "loss_cpu": loss_cpu, "loss_tol": AE_LOSS_REL_TOL, "gradients": len(grads_cpu),
         "worst_err_over_limit": worst, "worst_grad": worst_name,
         "worst_err_over_max": plain_worst, "zero_gradients": len(zero), "cpu_s": cpu_s})


def ae_profile(trainer, gen, batch, median_ms):
    """torch.profiler over one AE step: the card's kernel time summed, its
    share of the unprofiled median step (the rest is the card idle, waiting
    on the host), and the ops that launched the most kernel time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(gen.manual_seed(20), batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in device_events) / 1e3
    ops = sorted(((a.self_device_time_total / 1e3, a.key) for a in prof.key_averages()
                  if a.device_type == DeviceType.CPU and a.self_device_time_total > 0),
                 reverse=True)
    log({"phase": "AE step profile", "kernel_ms": busy_ms, "device_events": len(device_events),
         "profiled_step_ms": wall_ms,
         "busy_share_of_median_step": busy_ms / median_ms,
         "top_ops_kernel_ms": [[name, ms] for ms, name in ops[:12]]})


def ae_phase(table, btable, ae_btable, card, others=None):
    """Stage-1 training at full KTH width: warm-up with recording, backward
    kernel checks, timed steps with launch counts (every kernel of the three
    tables), float32 card vs CPU."""
    from extdm_tpu_torch.config import kth_ae_training_config

    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's defaults, which train_step runs under
    torch.backends.cuda.matmul.allow_tf32 = False
    tf32 = {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    cfg = kth_ae_training_config()
    trainer = ae_model_and_trainer(cfg, "cuda")
    px = cfg["frame_shape"]
    g = torch.Generator().manual_seed(3)
    batch = {k: torch.randint(0, 256, (AE_BATCH, px, px), generator=g, dtype=torch.uint8).cuda()
             for k in ("source", "driving")}
    gen = torch.Generator(device="cuda")
    warp = {"grid_sample": table["grid_sample"]}

    record, frecord = {}, {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with recording(warp, frecord), recording(ae_btable, record):
        aux = trainer.train_step(gen.manual_seed(0), batch)
        torch.cuda.synchronize()
    log({"phase": "AE warm-up step", "seconds": time.perf_counter() - t0,
         "losses": {k: v.item() for k, v in aux.items()},
         "forward_shapes": [str(k) for k in frecord["grid_sample"]],
         "backward_shapes": [str(k) for k in record["grid_sample_bwd"]]})
    want = {"grid_sample": 6, "grid_sample_bwd": 5}
    seen = {n: sum(e["count"] for e in r.values()) for n, r in {**frecord, **record}.items()}
    if seen != want:
        raise AssertionError(f"AE warm-up warp calls {seen} != expected {want}")

    summary = ae_backward_phase(ae_btable, record, card)
    grad_fn_check()
    del record
    fwd_ms = 0.0  # the forward warp kernel per step at the AE shapes (timed only)
    with torch.no_grad():
        for entry in frecord["grid_sample"].values():
            fwd_ms += entry["count"] * cuda_ms(
                lambda: table["grid_sample"]["wrapper"](*entry["args"], **entry["kwargs"]), 5)
    del frecord

    trainer.train_step(gen.manual_seed(9), batch)  # once more after the checks, untimed
    torch.cuda.synchronize()
    counters = {n: k["wrapper"] for n, k in {**table, **btable, **ae_btable,
                                             **(others or {})}.items()}
    expected = {n: want.get(n, 0) for n in counters}
    times = []
    for i in range(TIMED_STEPS):
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        aux = trainer.train_step(gen.manual_seed(10 + i), batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches = {n: fn.launches for n, fn in counters.items()}
        losses = {k: v.item() for k, v in aux.items()}
        if not all(math.isfinite(v) for v in losses.values()):
            raise AssertionError(f"AE step {i}: losses {losses}")
        if launches != expected:
            raise AssertionError(f"AE step {i}: launches {launches} != expected {expected}")
        log({"phase": "AE step", "step": i, "ms": times[-1] * 1e3, "losses": losses})
    med = statistics.median(times)
    bwd_ms = summary["grid_sample_bwd"]["ms"]
    log({"phase": "AE end to end", "config": "configs/AE/kth.yaml: 64px, 10 regions, VGG19 "
         "perceptual x3 scales, TPS equivariance, Adam; float32", "batch": AE_BATCH,
         "ms_per_step": [t * 1e3 for t in times], "median_ms": med * 1e3,
         "pairs_per_s": AE_BATCH / med, "launches_per_step": launches,
         "warp_kernels_ms": fwd_ms + bwd_ms, "warp_forward_ms": fwd_ms, "warp_backward_ms": bwd_ms,
         "rest_ms_by_difference": med * 1e3 - fwd_ms - bwd_ms,
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30, "tf32": tf32, "card": card})
    ae_profile(trainer, gen, batch, med * 1e3)
    del trainer, batch
    torch.cuda.empty_cache()
    ae_f32_card_vs_cpu(cfg)
    log({"phase": "AE phase", "seconds": time.perf_counter() - t_phase})
    return summary, launches


# ----------------------------------------------------------------- evaluation
def wm_table(table):
    """Kernel 9 in the layout of kernel_table. Its wrapper takes pre-windowed
    tokens; the layers are recorded at the UNet's call site (kernel 1's), so
    key, cost and residual are kernel 1's on the layer's input x."""
    from extdm_tpu_torch.ops import fused_stw

    return {"stw_layer_wm": dict(
        wrapper=fused_stw.fused_stw_layer_wm, plain=fused_stw.stw_layer_wm_plain,
        sites=table["stw_layer"]["sites"], key=table["stw_layer"]["key"],
        cost=table["stw_layer"]["cost"], residual=None,
        source="extdm_tpu_torch/csrc/attention.cu", replaces="extdm_tpu/ops/pallas_stw.py:781")}


def wm_inputs(x, gamma, w_qkv, w_proj, b_proj, bias, *, window, shift, heads, dim_head,
              eps=1e-5, **_):
    """Kernel 9's operands for one STW layer, as the layer's route makes them."""
    from extdm_tpu_torch.ops import fused_stw

    xw, masks_exp, _ = fused_stw.wm_operands(x, window, shift)
    return ((xw, gamma, w_qkv, w_proj, b_proj, bias, masks_exp),
            dict(heads=heads, dim_head=dim_head, eps=eps))


def wm_kernel_phase(table, record, card):
    """Kernel 9 at every window-major layer the eval records (bf16): against
    its plain version, and the layer through kernel 9 against the layer
    through kernel 1 on the same inputs; times of kernel 9, its plain
    version, the layer through each kernel; then a shifted layer in mode
    "1" with its expanded masks, and one float32 shape."""
    from extdm_tpu_torch.ops import fused_stw

    k9 = wm_table(table)["stw_layer_wm"]
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0, library_ms=None,
               max_abs_err=0.0, layer_ms=0.0, kernel1_layer_ms=0.0)
    shifted_case = None
    for key, entry in record.items():
        args, kwargs, count = entry["args"], entry["kwargs"], entry["count"]
        x, (window, shift) = args[0], key[1:]
        _, T, H, W, _ = x.shape
        _, ph, pw = fused_stw._pads(T, H, W, window)
        if any(shift) and shifted_case is None and min(H + ph, W + pw) >= 32:
            shifted_case = (args, kwargs)
        if not fused_stw.window_major_gate(kwargs["window_major"], any(shift),
                                           min(H + ph, W + pw)):
            continue
        wargs, wkw = wm_inputs(*args, **kwargs)
        res = check(f"stw_layer_wm{key}", k9["wrapper"](*wargs, **wkw), k9["plain"](*wargs, **wkw),
                    BF16_REL_TOL, wargs[0])
        layer = {m: dict(kwargs, window_major=m) for m in ("1", "0")}
        res_k1 = check(f"stw_layer_wm{key} vs kernel 1",
                       table["stw_layer"]["wrapper"](*args, **layer["1"]),
                       table["stw_layer"]["wrapper"](*args, **layer["0"]), BF16_REL_TOL, x)
        ms = cuda_ms(lambda: k9["wrapper"](*wargs, **wkw), 10)
        plain_ms = cuda_ms(lambda: k9["plain"](*wargs, **wkw), 10)
        layer_ms = cuda_ms(lambda: table["stw_layer"]["wrapper"](*args, **layer["1"]), 10)
        k1_ms = cuda_ms(lambda: table["stw_layer"]["wrapper"](*args, **layer["0"]), 10)
        byts, flops, op_dtype = k9["cost"](*args, **kwargs)
        bytes_ms, ops_ms = byts / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[op_dtype] * 1e3
        log({"kernel": "stw_layer_wm", "shape": list(wargs[0].shape), "layer_shape": list(key[0]),
             "key": str(key[1:]), "dtype": str(x.dtype).replace("torch.", ""), "per_call": count,
             "kernel_ms": ms, "plain_ms": plain_ms, "layer_ms_window_major": layer_ms,
             "layer_ms_kernel1": k1_ms, "library_ms": None,
             "library_ms_note": "no single PyTorch call computes this layer",
             "bound_ms": max(bytes_ms, ops_ms),
             "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", **res,
             "vs_kernel1_max_abs_err": res_k1["max_abs_err"], "card": card})
        for name, v in (("ms", ms), ("plain_ms", plain_ms), ("layer_ms", layer_ms),
                        ("kernel1_layer_ms", k1_ms), ("bound_ms", max(bytes_ms, ops_ms)),
                        ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
            tot[name] += count * v
        tot["max_abs_err"] = max(tot["max_abs_err"], res["max_abs_err"])

    # mode "1": a shifted layer goes window-major with its expanded masks
    args, kwargs = shifted_case
    wargs, wkw = wm_inputs(*args, **kwargs)
    res = check("stw_layer_wm shifted (masks)", k9["wrapper"](*wargs, **wkw),
                k9["plain"](*wargs, **wkw), BF16_REL_TOL, wargs[0])
    res_k1 = check("shifted layer, mode 1 vs kernel 1",
                   table["stw_layer"]["wrapper"](*args, **dict(kwargs, window_major="1")),
                   table["stw_layer"]["wrapper"](*args, **dict(kwargs, window_major="0")),
                   BF16_REL_TOL, args[0])
    log({"kernel": "stw_layer_wm", "shape": list(wargs[0].shape), "masks": list(wargs[6].shape),
         "check": "shifted layer in mode 1: kernel vs plain, and vs kernel 1", **res,
         "vs_kernel1_max_abs_err": res_k1["max_abs_err"]})

    torch.backends.cuda.matmul.allow_tf32 = False
    fargs, fkw = next((a, k) for n, a, k in f32_cases(torch.device("cuda")) if n == "stw_layer")
    for shift in ((2, 2, 2), (0, 0, 0)):
        wargs, wkw = wm_inputs(*fargs, **dict(fkw, shift=shift))
        res = check(f"stw_layer_wm float32 shift {shift}", k9["wrapper"](*wargs, **wkw),
                    k9["plain"](*wargs, **wkw), F32_REL_TOL)
        log({"kernel": "stw_layer_wm", "shape": list(wargs[0].shape), "dtype": "float32",
             "shift": list(shift), "check": "kernel vs plain", **res})

    # under autograd the window-major layer's backward is kernel 5, as kernel 1's
    g = torch.randn(fargs[0].shape, generator=torch.Generator(device="cuda").manual_seed(9),
                    device="cuda")
    grads, before = {}, (fused_stw.stw_layer_bwd.launches, fused_stw.fused_stw_layer_wm.launches)
    for mode in ("1", "0"):
        x = fargs[0].clone().requires_grad_(True)
        out = fused_stw.fused_stw_layer(x, *fargs[1:], **dict(fkw, window_major=mode))
        grads[mode] = (out.detach(), torch.autograd.grad(out, x, g)[0])
    after = (fused_stw.stw_layer_bwd.launches, fused_stw.fused_stw_layer_wm.launches)
    if after != (before[0] + 2, before[1] + 1):
        raise AssertionError(f"autograd through the window-major layer: backward / kernel 9 "
                             f"launches {before} -> {after}, expected +2 / +1")
    res = check("window-major layer under autograd: output", grads["1"][0], grads["0"][0],
                F32_REL_TOL)
    res_dx = check("window-major layer under autograd: dx", grads["1"][1], grads["0"][1],
                   F32_REL_TOL)
    log({"kernel": "stw_layer_wm", "check": "autograd (float32): mode 1 vs mode 0, backward "
         "through kernel 5", "shape": list(fargs[0].shape), "out": res, "dx": res_dx})
    return tot


def check_metrics_card_vs_cpu(out, i3d, lpips):
    """PSNR, SSIM (float64), LPIPS and I3D features (float32) of the eval's
    videos on the card against the port's CPU versions on the same videos
    (the first two real videos and their trajectories; I3D on their first
    16 frames), TF32 off."""
    from extdm_tpu_torch.metrics import I3DExtractor, LPIPSMetric, calculate_psnr3, calculate_ssim3

    n = 2 * EVAL_TRAJ
    samples = out["samples"][:n]
    real = out["real"][:2].repeat_interleave(EVAL_TRAJ, dim=0)
    t0 = time.perf_counter()
    res = {}
    tchw = lambda v: v.permute(0, 1, 4, 2, 3)  # noqa: E731
    for name, fn, tol in (("psnr", calculate_psnr3, METRIC_F64_TOL),
                          ("ssim", calculate_ssim3, METRIC_F64_TOL)):
        got, want = fn(tchw(samples), tchw(real)), fn(tchw(samples.cpu()), tchw(real.cpu()))
        res[name] = float(abs(got - want).max())
        if not (res[name] <= tol and math.isfinite(res[name])):
            raise AssertionError(f"{name} card vs cpu: max error {res[name]} > {tol}")
    lp_cpu = LPIPSMetric(device="cpu")
    lp_cpu.model.load_state_dict(lpips.model.state_dict())
    got = lpips.calculate_lpips3(samples, real)
    want = lp_cpu.calculate_lpips3(samples.cpu(), real.cpu())
    res["lpips"] = float(abs(got - want).max())
    if not res["lpips"] <= LPIPS_F32_TOL:
        raise AssertionError(f"lpips card vs cpu: max error {res['lpips']} > {LPIPS_F32_TOL}")
    i3d_cpu = I3DExtractor(device="cpu")
    i3d_cpu.model.load_state_dict(i3d.model.state_dict())
    clips = out["real"][:2, :16]
    got, want = i3d.get_feats(clips), i3d_cpu.get_feats(clips.cpu())
    size = float(abs(want).max())
    res["i3d"] = float(abs(got - want).max())
    res["i3d_feature_max"] = size
    res["i3d_videos_apart"] = float(abs(want[0] - want[1]).max())
    if not res["i3d"] <= I3D_F32_REL_TOL * size:
        raise AssertionError(f"i3d features card vs cpu: max error {res['i3d']} > "
                             f"{I3D_F32_REL_TOL} x {size}")
    log({"check": "metrics card vs CPU (float64 PSNR/SSIM, float32 LPIPS/I3D, TF32 off)",
         "max_abs_err": res, "tol": {"psnr": METRIC_F64_TOL, "ssim": METRIC_F64_TOL,
                                      "lpips": LPIPS_F32_TOL, "i3d_rel": I3D_F32_REL_TOL},
         "videos": n, "cpu_s": time.perf_counter() - t0})


def eval_phase(table, btable, ae_btable, card):
    """The evaluation path at full KTH width (see the module docstring, 8)."""
    import numpy as np

    from extdm_tpu_torch.config import kth_sampling_config
    from extdm_tpu_torch.data import (DataLoader, InMemoryVideoStore, VideoDataset,
                                      make_moving_shapes_video)
    from extdm_tpu_torch.eval.valid_dm import evaluate
    from extdm_tpu_torch.metrics import I3DExtractor, LPIPSMetric
    from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusion

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    torch.backends.cudnn.allow_tf32 = False  # the metric networks in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = kth_sampling_config(dtype=torch.bfloat16, stw_window_major="auto")
    tc, tp, px = cfg.cond_frames, cfg.pred_frames, cfg.frame_shape
    total_pred = EVAL_FRAMES - tc
    fd = FlowDiffusion(cfg, device="cuda", seed=0)
    rng = np.random.RandomState(0)
    store = InMemoryVideoStore([make_moving_shapes_video(rng, EVAL_FRAMES, px)
                                for _ in range(EVAL_VIDEOS)], name="synthetic")
    dataset = VideoDataset(store, type="valid", total_videos=EVAL_VIDEOS, num_frames=EVAL_FRAMES,
                           image_size=px, random_time=False, raw_uint8=True)
    wm = wm_table(table)
    stw = {"stw_layer": table["stw_layer"]}

    # warm-up: one sampler call at the eval's batch, recording the STW layers
    record = {}
    cond = torch.rand((EVAL_VIDEOS * EVAL_TRAJ, tc, px, px, 3),
                      generator=torch.Generator().manual_seed(4)).cuda()
    for k in {**table, **wm}.values():
        k["wrapper"].launches = 0
    t0 = time.perf_counter()
    with recording(stw, record):
        fd.make_sampler()(torch.Generator(device="cuda").manual_seed(0), cond)
        torch.cuda.synchronize()
    want_call = dict(expected_launches(cfg), stw_layer=160, stw_layer_wm=20)
    seen = {n: k["wrapper"].launches for n, k in {**table, **wm}.items()}
    log({"phase": "eval warm-up call", "seconds": time.perf_counter() - t0, "launches": seen})
    if seen != want_call:
        raise AssertionError(f"eval warm-up launches {seen} != expected {want_call}")
    summary = wm_kernel_phase(table, record["stw_layer"], card)
    del record

    # the main path: counters from 0, the loader and evaluate()
    i3d, lpips = I3DExtractor(device="cuda"), LPIPSMetric(device="cuda")
    loader = DataLoader(dataset, EVAL_VIDEOS, shuffle=False, num_workers=4, drop_last=False,
                        device="cuda")
    counters = {n: k["wrapper"] for n, k in {**table, **btable, **ae_btable, **wm}.items()}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = evaluate(fd, loader, num_traj=EVAL_TRAJ, total_pred=total_pred, seed=1, i3d=i3d,
                   lpips=lpips)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in counters.items()}
    calls = len(out["seconds"]["sampling_per_call"])
    expected = {n: want_call.get(n, 0) * calls for n in counters}
    if calls != math.ceil(total_pred / tp) or launches != expected:
        raise AssertionError(f"eval: {calls} sampler calls, launches {launches} != expected "
                             f"{expected}")
    for line in out["lines"]:
        print(line, flush=True)
    n = EVAL_VIDEOS * EVAL_TRAJ
    samples = out["samples"]
    if tuple(samples.shape) != (n, EVAL_FRAMES, px, px, 3) or not torch.isfinite(samples).all():
        raise AssertionError(f"eval samples: shape {tuple(samples.shape)} or non-finite")
    vals = out["values"]
    for k in ("fvd_best", "psnr2", "ssim2", "lpips2", "sampling_frames_per_sec"):
        if not math.isfinite(vals[k]):
            raise AssertionError(f"eval {k} = {vals[k]}")
    if not all(math.isfinite(v) for v in vals["fvd_traj"]):
        raise AssertionError(f"eval fvd_traj = {vals['fvd_traj']}")
    sec = out["seconds"]
    metric_s = {k: sec[k] for k in ("i3d_real", "i3d_samples", "frechet", "psnr", "ssim", "lpips")}
    log({"phase": "eval end to end", "config": "KTH 64px tc=10 tp=20 DDIM-10 bf16, STW layout auto",
         "videos": EVAL_VIDEOS, "trajectories": EVAL_TRAJ, "sampler_batch": n,
         "sampler_calls": calls, "ms_per_sampler_call": [t * 1e3 for t in sec["sampling_per_call"]],
         "sampling_frames_per_sec": vals["sampling_frames_per_sec"],
         "launches": launches, "launches_per_sampler_call": {k: v // calls for k, v in
                                                             launches.items()},
         "metrics_s": metric_s, "metrics_total_s": sum(metric_s.values()),
         "loader_wait_s": sec["loader_wait"], "eval_s": eval_s,
         "stw_layer_wm_ms_per_call": summary["ms"],
         "kernel1_same_layers_ms_per_call": summary["kernel1_layer_ms"],
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30, "card": card})
    check_metrics_card_vs_cpu(out, i3d, lpips)
    del fd, out, i3d, lpips
    torch.cuda.empty_cache()
    log({"phase": "eval phase", "seconds": time.perf_counter() - t_phase})
    return summary, launches, calls


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
    wm = wm_table(table)
    want = dict(want, stw_layer_wm=0)  # layout "0": no window-major layer
    times, launches = [], {}
    for i in range(TIMED_CALLS):
        for k in {**table, **wm}.values():
            k["wrapper"].launches = 0
        t0 = time.perf_counter()
        out = sampler(gen.manual_seed(100 + i), cond)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches = {n: k["wrapper"].launches for n, k in {**table, **wm}.items()}
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
    del fd, sampler
    torch.cuda.empty_cache()

    # ---- the DM train path
    btable, ae_btable = backward_table(table), ae_backward_table()
    bsummary, train_launches = train_phase(table, btable, card, others={**ae_btable, **wm})

    # ---- the AE (stage-1) train path
    aesummary, ae_launches = ae_phase(table, btable, ae_btable, card, others=wm)

    # ---- the evaluation path (kernel 9)
    wsummary, eval_launches, eval_calls = eval_phase(table, btable, ae_btable, card)

    # each kernel's launches: on the sampling path for the forward kernels,
    # on the DM train path for its backward kernels, on the AE path for the
    # grid-sample backward, on the eval path (all its sampler calls) for
    # kernel 9; with the DM, AE and eval counts of every kernel
    summaries = {**summary, **bsummary, **aesummary, **{"stw_layer_wm": wsummary}}
    kernels = []
    for name, k in {**table, **btable, **ae_btable, **wm}.items():
        s = summaries[name]
        path_launches = (eval_launches[name] if name in wm else launches.get(
            name, train_launches[name] if name in btable else ae_launches[name]))
        kernels.append({"name": name, "route": "cuda", "source": k["source"],
                        "replaces": k["replaces"], "launches": path_launches,
                        "train_step_launches": train_launches[name],
                        "ae_step_launches": ae_launches[name],
                        "eval_launches": eval_launches[name], "eval_sampler_calls": eval_calls,
                        "max_abs_err": s["max_abs_err"], "ms": s["ms"], "plain_ms": s["plain_ms"],
                        "bound_ms": s["bound_ms"],
                        "bound_by": "bytes" if s["bytes_ms"] >= s["ops_ms"] else "operations",
                        "library_ms": s["library_ms"],
                        **({"kernel1_same_layers_ms": s["kernel1_layer_ms"],
                            "layer_ms_with_partition": s["layer_ms"]} if name in wm else {})})
    log({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
