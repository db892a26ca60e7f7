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
   with CUDA events; kernels 1, 2, 3 and 4 also by their own device time
   (torch.profiler), with their device TFLOP/s and share of the bound,
   kernel 2 beside the device time of the parent's body (attention.cu) on
   the same inputs, kernel 4 beside F.grid_sample's device time (the bytes
   model of kernels 4 and 8's bounds is printed once);
   kernel 1 against its plain version at STW_RAGGED (windows clamped to 16
   and 32 tokens, 96, 192 and 320 channels), kernel 3 at RESNET_RAGGED
   (6 x 6 and 5 x 7 frames, Cin != Cout, channels off multiples of 64) and
   at SCRATCH_BLOCK (an evaluation batch of 100 trajectories, whose scratch
   passes 2 GiB).
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
   shape in float32, and times both (kernels 5, 6 and 7 also by their device
   time, kernel 6 beside the parent's body, attention_bwd.cu; kernels 6 and
   7 twice on the same inputs for bitwise equal gradients; kernel 5 against
   its plain version at STW_RAGGED, its plan at every width it takes; kernel
   7 at RESNET_RAGGED; kernels 2 and 6 at TEMPORAL_RAGGED, with the operands
   their entries write held against their plain version; kernel 7's device
   time split by kernel name beside the decomposed route's,
   resnet_bwd_split.py); takes 3 timed steps with the counters
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
   (C >= 67), in bf16, twice for a bitwise equal d_grid, and times kernel,
   plain version and ATen's grid_sampler_2d_backward (CUDA events and device
   time); checks kernels 4 and 8 at WARP_RAGGED (all padding modes, points
   on the clamp and fold lines, a NaN grid point, operands off a 16-byte
   boundary);
   takes 3 timed steps with the counters from 0 (6
   grid-sample forward and 5 backward launches per step); and compares one
   float32 loss and every gradient at batch 2, kernels on the card against
   the plain versions on the CPU, with the same weights, augmentation and
   TPS draws; one more step runs under torch.profiler for the card's busy
   share and the ops that take its time.
8. The DM training job: ``train/train_dm.py`` ``main`` in-process on a
   copy of configs/DM/kth.yaml with every cadence at 1 or 2, at full width
   in bf16, batch 8 of 8 in-memory moving-shapes videos, the LFAE random: 4
   steps with a validation, shots and checkpoints at step 2, then a
   --set_start resume from the final checkpoint to step 6. Checks the
   launches of every train step (18 / 10 / 20 layers forward and backward,
   1 grid sample) and validation sampler call (180 / 91 / 200 / 5), that
   the resumed run starts at step 4 with the checkpoint's parameters and
   AdamW moments, finite losses, the logs, shots and checkpoints, and that
   eval/valid_dm.load_weights reads the checkpoint; prints the job's ms per
   step beside the train phase's, its data wait and the seconds of each
   validation, shot and checkpoint write.
9. The AE training job: ``train/train_ae.py`` ``main`` on a copy of
   configs/AE/kth.yaml (num_repeats 8: one batch of 64 pairs from 8
   in-memory videos an epoch) with --device_augment, 4 steps and a resume
   as above, then two steps with the host augmentation (numpy, no cv2),
   then eval/valid_ae on the checkpoint. Checks 6 / 5 grid-sample launches
   a step and the rest as for the DM job; prints the same timing lines.
   Then the data feed: the AE job with host augmentation, 2 steps on
   --loader process and 2 on --loader thread (launches a step equal, each
   run's data wait, ms per step, the bare step's and the host's cores),
   and 30 steps each at 64 repeats, 8 batches an epoch;
   the first two batches a process loader ships to the card against a
   process loader with device=None on the same seed, bitwise; the DM job 2
   steps on --loader process. Without h5py (the card's machine),
   HDF5VideoStore and HDF5VideoWriter must raise an ImportError naming it;
   with h5py the DM job also runs on shards from write_video_hdf5 with
   --clip_cache_mb, printing the prefill seconds. A line says which ran.
   Then the artefacts (``artefacts_phase``): eval/valid_dm.py ``main`` on
   configs/DM/kth.yaml (float32, 2 synthetic videos x 2 trajectories) with
   --dump_arrays --dump_flow: every file, the sampler calls' launches,
   kernel 4's 1 launch in the GT-flow encode, origin_flows.npy against the
   LFAE's plain encode on the CPU, the seconds of the gif, arrays and
   pngs; eval/analyze_dumps.py on the dumps; eval/video2video.py on 3
   synthetic videos (5 kernel-4 launches in its encode, the transfer
   against the same encode with the warps on their plain version, ms per
   encode call); metrics/demo.py at 8 x 30 x 64^2 (each metric's seconds,
   PSNR and SSIM against the CPU's).
10. Evaluation: the KTH sampling configuration in bf16 with the STW layout
   in "auto" (window-major on the two unshifted 32x32 layers: kernel 9);
   4 in-memory 64 px gray moving-shapes videos of 50 frames through the
   port's VideoDataset and DataLoader (raw uint8, pinned, canonicalised on
   the card), 4 trajectories each (sampler batch 16), 2 autoregressive
   rounds of 20 frames. A recorded warm-up call gives kernel 9's inputs:
   kernel 9 (bf16: kernel 1's body on a window's contiguous rows) is
   checked against its plain version and against kernel 1 on the same
   layers, at a shifted shape with its expanded masks (mode "1"), at
   WM_EXTRA (512 channels, a 32-token window, 144 windows) and at one
   float32 shape (attention.cu's body), and timed beside kernel 1 (call and
   device time) and the parent's body (attention.cu). Then the
   counters go to 0 and ``evaluate`` runs (20 kernel-9 and 160 kernel-1
   launches per sampler call), with PSNR, SSIM, LPIPS and FVD from random
   networks; PSNR, SSIM, LPIPS and I3D features on the card are checked
   against the port's CPU versions on the same videos. ``evaluate`` returns
   its samples in host memory; run again at 8 trajectories (2 videos per
   loader batch, the same sampler batch), its peak device memory must stay
   within EVAL_PEAK_REL_TOL of the 4-trajectory run's.
11. multi1248: the KTH sampling configuration with the multi1248/ada UNet
   (dim_mults (1,2,4,8): 512 channels at the deepest level and in the mid
   blocks) in bf16. The layers over the narrow kernels' 256 channels
   (``wide_layers``: 4 window layers, 1 temporal layer, 4 resnet blocks)
   take their routes (``stw_route``): the window layers run kernel 1
   forward and kernel 5 backward, the temporal layer kernel 2 forward and
   kernel 6 backward (their bf16 bodies take 512 channels), so no layer
   runs unfused; the resnet blocks' backward runs kernel 7 (its bf16 body
   takes any width).
   A recorded warm-up sampler call at batch 4 (no kernel-12 call, no
   unfused layer); kernel 12 where it ran before kernels 2 and 6 took the
   temporal layer (``temporal_layer_unfused`` called on that layer's
   recorded inputs) against its plain version in bf16 and float32, timed
   beside its plain version and F.scaled_dot_product_attention (the wrapper
   call with CUDA events, the kernel's own device time with
   torch.profiler), the unfused layer there timed whole, as a plain layer,
   and split into kernel 12 and the torch ops around it; kernels 1 and 2
   against their plain versions at the 512-channel window and temporal
   layers, timed (call and device); kernel 3 against its plain version at
   every block (512 output channels and up level 0's 1024 input channels
   among them), timed (call and device); 3 timed sampler calls with every
   launch count and the routes checked (``expected_route_launches``: no
   unfused layer), kernels 1 and 2 on none over 512 channels; the float32
   UNet card vs CPU, whose layers over 256 channels take kernel 12 (its
   launches there are kernel 12's in the summary line). Then the train step
   at batch 8 (remat, bf16 compute): a recorded warm-up step, kernels 5 and
   6 against their plain backwards at the 512-channel window and temporal
   layers (call and device time; kernel 6 twice, bitwise), kernel 7 against
   its plain backward at every block of the step (bf16, batch 8: the 512-
   channel blocks and up level 0's 1024 input channels among them; twice,
   bitwise; call and device time), kernel 7 against the decomposed route at
   the blocks over 256 channels (its route before), kernels 10 and 11
   against their plain versions at that route's conv shapes, kernel 12 at
   the temporal layer's training inputs (as in sampling), in bf16 and
   float32 (dW with the backward kernels' limits) and timed beside F.conv3d
   / aten.convolution_backward / SDPA (call and device time, device TFLOP/s
   and share of the bound), kernels 10 and 11 also at three ragged shapes
   (CONV_RAGGED) and kernel 11 twice on the same inputs (bitwise equal din
   and dW), the unfused temporal layer's forward and backward on the same
   inputs timed and split as above, kernels 1, 2, 5 and 6 never over 512
   channels, 3 timed steps with launch and route counts (no layer unfused,
   no resnet backward decomposed, kernels 10-12 never: a line prints them),
   and the float32 step card vs CPU, counted from 0: there every block over
   256 channels takes the decomposed route (kernel 7's float32 body keeps
   256), so kernels 10 and 11 run twice each per such block.

12. w_ref/traj: ``config.kth_traj_config()`` (window (2, 4, 4): N = 32
   tokens a window, shift (1, 2, 2) over T = 30; TrajWarp at every DDIM
   step, no cond cache; adaptors from level 2) in bf16. A recorded warm-up
   sampler call at batch 4; kernel 1 against its plain version at each of
   its N = 32 layer shapes (bf16 limits and branch limits; call and device
   time); 3 timed calls with every launch count (180 / 90 / 200 / 5: no
   cond-stream temporal layer); the float32 traj UNet at batch 1, card vs
   CPU. Then its train step at batch 8 (remat, bf16 compute): a recorded
   warm-up step, kernel 5 against the plain backward at each N = 32 shape,
   3 timed steps with launch counts (18 / 9 / 20 forward and backward).
13. AE bf16: the AE step at batch 64 with ``ReconstructionModel(dtype=
   bfloat16)``: a recorded warm-up step, kernels 4 and 8 at its shapes
   (bf16 images, and the float32 TPS warp) against their plain versions,
   the losses against the float32 step's on the same batch, weights and
   draws (AE_BF16_LOSS_REL_TOL), float32 parameters, gradients and
   BatchNorm statistics after the step, 3 timed steps (6 / 5 warp
   launches) beside the float32 step's median; then ``train_ae.main
   --bf16`` for 2 steps ("AE job").
14. DP (data parallel): single-process references first (the KTH DM step
   in bf16 at batch 8, twice from the same state for its repeat spread;
   the AE step at batch 64 on the same raw pairs, augmentation and TPS
   draws, and once more on its frames moved by AE_ROUGH_EPS, TF32 off),
   then 2 spawned ranks on cuda:0 over gloo (and over nccl,
   one rank a card, where there are 2 cards or more): each rank takes the
   data-parallel DM step on its 4 rows (the draws given), the AE step with
   SyncBN on its 32 pairs and the sharded sampler (batch 4, 2 rows a rank),
   with every launch counter from 0 before each; checks every rank's
   launches against world 1's (each layer on its kernel at the local
   batch), the ranks' parameters equal after each step, the DM and AE
   parameters, gradients, losses and running statistics against the
   single-process step within SPREAD_MULT of its spread, and each rank's rows of
   the sharded sample against the plain sampler on its rows with its
   rank's generator (the same rule); prints each rank's ms per step or
   call and the ms of the gradient, SyncBN, loss and gather all-reduces.
15. spatial (sequence-parallel sampling): kernel 1 on a shard's windows
   (the global shift-mask table, the ids cut to the shard's H windows) at
   KTH shapes with shift (2, 2, 2) and an H-only shift (0, 2, 0), and in
   float32, each shard against the plain layer on its inputs and the
   shards joined against the plain layer on the global tensor; then the
   single-process references (the KTH sampler in bf16 at batch 4 twice,
   the world-1 spatial call, one UNet forward; a configs/DM/cityscapes.yaml
   call at 128 px, batch 2) and 2 spawned ranks on cuda:0 over gloo (data
   1 x model 2; nccl one rank a card with 2 cards, (2, 2) with 4): each
   rank's UNet forward and sampler results against them (see
   SPATIAL_MAX_REL_TOL), its launches per call (180 / 91 / 0 / 5: no
   kernel 3), ms per call, the exchanges' ms and counts by kind, and its
   peak and working memory beside the single process's.
The sampling phase also runs the sampler variants after its end-to-end
line: ``make_sampler(decode=False)`` and ``sample_video`` against
``make_sampler()`` on the same seed (SPREAD_MULT).

The train phase also runs an A/B of the two resnet backward routes: at the
KTH step's resnet-backward shapes (32^2 to 4^2 frames), kernels 10 and 11
are first checked against their plain versions at every conv shape of the
decomposed backward (bf16 and float32), timed, and kernel 11 checked to
repeat bit for bit; then kernel 7 against the decomposed backward (call
and device time), and the whole KTH step with every block's backward
decomposed (the gate ``resnet_bwd_route`` replaced for those steps)
against the step as it is, in turns, launches checked. Printed only. The
multi1248 phase runs the per-shape part at its blocks over 256 channels.

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
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

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
# evaluate at 8 trajectories against 4, the same sampler batch: the samples
# it keeps (39 MB more here) stay in host memory; the card's peak is the
# sampler's and one metric slab's, which may move by allocator rounding.
EVAL_PEAK_REL_TOL = 0.02
METRIC_F64_TOL = 1e-9
LPIPS_F32_TOL = 1e-4
I3D_F32_REL_TOL = 1e-3


# Kernels whose lines carry their own device time (torch.profiler), device
# TFLOP/s and share of the bound: 1-9, the redesigned main-path ones.
# Kernels 2, 6 and 9 also carry the device time of the parent's body
# (attention.cu / attention_bwd.cu, which keeps float32) on the same inputs;
# kernels 4 and 8 the device time of the wrapper's other ops and of the
# library call.
DEVICE_TIMED = ("stw_layer", "temporal_layer", "resnet_block", "stw_layer_bwd",
                "temporal_layer_bwd", "resnet_block_bwd", "stw_layer_wm", "grid_sample",
                "grid_sample_bwd")


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


def kernel_symbols(source: str) -> set:
    """The __global__ functions of a CUDA source of the repo and of the
    headers it includes (common.cuh, temporal.cuh, ...)."""
    csrc = Path(__file__).resolve().parent / "extdm_tpu_torch" / "csrc"
    todo, seen, text = [Path(source).name, "common.cuh"], set(), ""
    while todo:
        name = todo.pop()
        if name not in seen:
            seen.add(name)
            src = (csrc / name).read_text()
            text += src
            todo += re.findall(r'#include "([^"]+)"', src)
    return set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", text))


def device_ms(fn, reps: int, symbols: set | None = None, attempts: int = 3) -> tuple:
    """(own, other): device time per fn() call of the kernels named
    `symbols` (of every device op when None) and of every other device op
    fn() issues (a wrapper's casts and copies), read by torch.profiler over
    `reps` calls after two warm-up calls. The host's time between launches
    is in neither. The profiler may drop an event: each op's time per call
    is its mean event time times its events per call, rounded. A session
    may also come back without the kernels' device records though they ran
    (seen on the card, late in a run: three empty sessions in a row), with
    device records of zero duration (seen the same way), or with a named
    kernel's records not a whole number per call (1 of 10 seen, which read
    as a tenth of its time; 9 of 10 is common). Such a session is run
    again, up to `attempts` times in all. The last session in which each
    named kernel (each op, when `symbols` is None) has a record of nonzero
    duration for at least half the calls stands; when none has, the
    reading is ``queued_ms``'s: every op fn() issues, the named kernels and
    the rest together, as own, and 0.0 as other, and a line says so and
    what the profiler recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    fn()
    torch.cuda.synchronize()
    pattern = re.compile(r"\b(" + "|".join(sorted(symbols)) + r")\b") if symbols else None
    reading = None
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name, empty = {}, set()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                if e.device_time <= 0:
                    empty.add(e.name)
                    continue
                n, t = by_name.get(e.name, (0, 0.0))
                by_name[e.name] = (n + 1, t + e.device_time)
        own = other = 0.0
        whole = usable = True
        for name, (n, t) in by_name.items():
            per_call = t / n * round(n / reps) if 2 * n >= reps else t / reps
            if pattern is None or pattern.search(name):
                own += per_call
                whole = whole and (pattern is None or n % reps == 0)
                usable = usable and 2 * n >= reps
            else:
                other += per_call
        usable = usable and own > 0.0 and not any(
            pattern is None or pattern.search(name) for name in empty)
        if usable:
            reading = (own / 1e3, other / 1e3)
            if whole:
                return reading
    if reading is not None:
        return reading
    ms = queued_ms(fn, reps)
    log({"device_ms": f"torch.profiler gave no usable reading in {attempts} sessions; read by "
                      "CUDA events with the host queued ahead (queued_ms), all ops as own",
         "symbols": sorted(symbols) if symbols else None, "ms": ms,
         "last_session": {name: list(v) for name, v in sorted(by_name.items())},
         "zero_duration": sorted(empty)})
    return ms, 0.0


_SLEEP_CYCLES_PER_MS = []


def queued_ms(fn, reps: int, attempts: int = 3) -> float:
    """Device time per fn() call by CUDA events, without the host's time
    between launches: a spin kernel (torch.cuda._sleep) holds the stream
    while the host issues `reps` calls, so the events span their device
    work back to back. Every op fn() issues counts. fn() must not wait on
    the card; a reading whose calls were not all issued before the spin
    ended is taken again with a longer spin, up to `attempts` times."""
    def timed(cycles: int) -> tuple:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        issued_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        return start.elapsed_time(end), issued_ms

    if not _SLEEP_CYCLES_PER_MS:  # the spin's rate: cycles per ms of this card
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(1 << 24)
        end.record()
        end.synchronize()
        _SLEEP_CYCLES_PER_MS.append((1 << 24) / start.elapsed_time(end))
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    spin_ms = 2.0 * (time.perf_counter() - t0) * 1e3 + 1.0
    for _ in range(attempts):
        ms, issued_ms = timed(int(_SLEEP_CYCLES_PER_MS[0] * spin_ms))
        if issued_ms < spin_ms:
            return ms / reps
        spin_ms = 2.0 * issued_ms + 1.0
    raise AssertionError(f"queued_ms: in {attempts} readings the host issued {reps} calls only "
                         f"after the spin ended (last: {issued_ms:.3f} ms)")


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

    def temporal_parent(x, *a, eps=1e-5, **k):
        # the parent's body (attention.cu; float32 and refused shapes since)
        return fused_stw._temporal_narrow(x.contiguous(), *a, eps=eps, **k)

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
            source="extdm_tpu_torch/csrc/stw_layer.cu", replaces="extdm_tpu/ops/pallas_stw.py:599"),
        "temporal_layer": dict(
            wrapper=fused_stw.fused_temporal_layer, plain=fused_stw.temporal_layer_plain,
            sites=[(unet3d, "fused_temporal_layer")], key=temporal_key, cost=temporal_cost,
            residual=temporal_residual, parent=temporal_parent,
            parent_source="extdm_tpu_torch/csrc/attention.cu",
            source="extdm_tpu_torch/csrc/stw_layer.cu",
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
            # an attention layer's output projection is not recomputed (its
            # output goes nowhere but the residual sum, so dO = g Wproj^T and
            # dWproj = o^T g are its only products): 2 n hid C fewer. Bytes:
            # x, g and dx once each, the weights and their float32 gradients,
            # and the bias table and its gradient.
            byts, flops, dtype = fwd_cost(x, *a, **k)
            flops *= 3
            if name in ("stw_layer", "temporal_layer"):
                flops -= 2 * (x.numel() // x.shape[-1]) * k["heads"] * k["dim_head"] * x.shape[-1]
            weights = [t for t in a if torch.is_tensor(t) and t.ndim >= 2]
            extra = x.numel() * x.element_size() + sum(t.numel() * 4 for t in weights)
            return byts + extra, flops, dtype
        return cost

    def temporal_parent(g, x, *a, eps=1e-5, **k):
        # the parent's body (attention_bwd.cu; float32 and refused shapes since)
        return fused_stw._temporal_bwd_narrow(g.to(x.dtype).contiguous(), x.contiguous(), *a,
                                              eps=eps, **k)

    entries = {
        "stw_layer_bwd": (fused_stw.stw_layer_bwd, fused_stw.stw_layer_plain_vjp, fused_stw,
                          "stw_layer", "extdm_tpu_torch/csrc/stw_layer_bwd.cu",
                          "extdm_tpu/ops/pallas_stw.py:1123"),
        "temporal_layer_bwd": (fused_stw.temporal_layer_bwd, fused_stw.temporal_layer_plain_vjp,
                               fused_stw, "temporal_layer", "extdm_tpu_torch/csrc/stw_layer_bwd.cu",
                               "extdm_tpu/ops/pallas_stw.py:2013"),
        "resnet_block_bwd": (fused_resnet.resnet_block_bwd, fused_resnet.resnet_block_plain_vjp,
                             fused_resnet, "resnet_block", "extdm_tpu_torch/csrc/resnet.cu",
                             "extdm_tpu/ops/pallas_resnet.py:594"),
    }
    table = {name: dict(wrapper=wrapper, plain=plain, sites=[(mod, name)],
                        key=bwd(forward[fwd]["key"]), cost=grad_cost(fwd), source=source,
                        replaces=replaces)
             for name, (wrapper, plain, mod, fwd, source, replaces) in entries.items()}
    table["temporal_layer_bwd"].update(parent=temporal_parent,
                                       parent_source="extdm_tpu_torch/csrc/attention_bwd.cu")
    return table


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


# Kernel 1 at window layers off the KTH sampler's: windows clamped by small
# volumes (get_window_size: N = 16 and 32 tokens) and widths that are not a
# multiple of 128 (its output's column rounds and 64-channel blocks ragged).
STW_RAGGED = (((2, 10, 2, 2, 128), (2, 2, 2)), ((2, 9, 4, 2, 192), (2, 2, 2)),
              ((1, 6, 8, 8, 320), (2, 2, 2)), ((3, 5, 8, 8, 96), (0, 0, 0)))


def stw_ragged_phase(table, card, seed=13):
    """Kernel 1 (bf16) against its plain version at STW_RAGGED, as the
    UNet's PreNormSTW calls it (window clamped to the volume); timed."""
    from extdm_tpu_torch.nn.attention import get_window_size

    k = table["stw_layer"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s, scale=1.0: torch.randn(s, generator=g, device="cuda") * scale  # noqa: E731
    heads, dh = 8, 32
    hid = heads * dh
    for shape, shift0 in STW_RAGGED:
        C = shape[-1]
        window, shift = get_window_size(shape[1:4], (4, 4, 4), shift0)
        N = math.prod(window)
        args = [r(*shape).bfloat16(), 1 + r(C, scale=0.1),
                r(3 * hid, C, scale=C ** -0.5).bfloat16(), r(C, hid, scale=hid ** -0.5).bfloat16(),
                r(C, scale=0.1).bfloat16(), r(heads, N, N, scale=0.1)]
        kwargs = dict(window=window, shift=shift, heads=heads, dim_head=dh)
        with torch.no_grad():
            res = check(f"stw_layer ragged {shape}", k["wrapper"](*args, **kwargs),
                        k["plain"](*args, **kwargs), BF16_REL_TOL, args[0])
            ms = cuda_ms(lambda: k["wrapper"](*args, **kwargs), 10)
        log({"kernel": "stw_layer", "shape": list(shape), "window": list(window),
             "shift": list(shift), "tokens": N, "dtype": "bfloat16", "kernel_ms": ms,
             "check": "kernel 1 vs plain at a ragged shape", **res, "card": card})


# Kernel 3 at blocks off the KTH sampler's: frames that are not a multiple
# of the 128-row tile and smaller than it (6 x 6, 5 x 7), Cin != Cout with the
# residual projection, channels not a multiple of 64 and, with 4 groups, not
# a multiple of 8 (padded to the kernels' 16-byte rows). (shape, Cout, groups)
RESNET_RAGGED = (((2, 3, 6, 6, 40), 96, 8), ((1, 4, 5, 7, 64), 64, 8),
                 ((2, 5, 5, 7, 96), 160, 8), ((2, 3, 6, 6, 20), 20, 4))


def resnet_ragged_phase(table, card, seed=17):
    """Kernel 3 (bf16) against its plain version at RESNET_RAGGED, the
    branch check included; timed."""
    k = table["resnet_block"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s, scale=1.0: torch.randn(s, generator=g, device="cuda") * scale  # noqa: E731
    for shape, cout, groups in RESNET_RAGGED:
        B, C = shape[0], shape[-1]
        args = [r(*shape).bfloat16(), r(cout, C, 1, 3, 3, scale=(9 * C) ** -0.5),
                r(cout, scale=0.1), 1 + r(cout, scale=0.1), r(cout, scale=0.1),
                r(B, 2 * cout, scale=0.3), r(cout, cout, 1, 3, 3, scale=(9 * cout) ** -0.5),
                r(cout, scale=0.1), 1 + r(cout, scale=0.1), r(cout, scale=0.1)]
        args += [r(cout, C, 1, 1, 1, scale=C ** -0.5), r(cout, scale=0.1)] if C != cout else [
            None, None]
        kwargs = dict(groups=groups)
        with torch.no_grad():
            res = check(f"resnet_block ragged {shape} -> {cout}", k["wrapper"](*args, **kwargs),
                        k["plain"](*args, **kwargs), BF16_REL_TOL,
                        k["residual"](*args, **kwargs))
            ms = cuda_ms(lambda: k["wrapper"](*args, **kwargs), 10)
        log({"kernel": "resnet_block", "shape": list(shape), "cout": cout, "groups": groups,
             "dtype": "bfloat16", "kernel_ms": ms, "check": "kernel 3 vs plain at a ragged shape",
             **res, "card": card})


# Kernel 3 where its scratch passes 2 GiB: KTH's up block at the 64-channel
# level (128 -> 64 channels, the residual projection, FiLM) at the batch of
# one evaluation call of the paper's 100 trajectories of a video. GroupNorm
# and FiLM are per sample, so samples of the batch are held against the plain
# block run on those samples alone.
SCRATCH_BLOCK = ((100, 30, 32, 32, 128), 64, 8)


def resnet_large_batch_phase(table, card, seed=23):
    """Kernel 3 (bf16) at SCRATCH_BLOCK: its scratch over 2 GiB, its first
    and last samples against the plain version, the branch check included."""
    from extdm_tpu_torch import _build
    from extdm_tpu_torch.ops import fused_resnet

    k = table["resnet_block"]
    (B, T, H, W, C), cout, groups = SCRATCH_BLOCK
    plan = fused_resnet.resnet_plan(B * T * H * W, C, cout, True,
                                    torch.cuda.get_device_properties(0).multi_processor_count)
    nbytes = _build.query("resnet", "resnet_scratch_bytes", B, B * T * H * W, plan.cin, plan.cout,
                          cout, groups, 1, 1)
    if nbytes < 2 ** 31:
        raise AssertionError(f"SCRATCH_BLOCK's scratch is {nbytes} bytes: not past 2 GiB")
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s, scale=1.0: torch.randn(s, generator=g, device="cuda") * scale  # noqa: E731
    x = r(B, T, H, W, C).bfloat16()
    params = [r(cout, C, 1, 3, 3, scale=(9 * C) ** -0.5), r(cout, scale=0.1),
              1 + r(cout, scale=0.1), r(cout, scale=0.1), r(B, 2 * cout, scale=0.3),
              r(cout, cout, 1, 3, 3, scale=(9 * cout) ** -0.5), r(cout, scale=0.1),
              1 + r(cout, scale=0.1), r(cout, scale=0.1), r(cout, C, 1, 1, 1, scale=C ** -0.5),
              r(cout, scale=0.1)]
    kwargs = dict(groups=groups)
    with torch.no_grad():
        before = k["wrapper"].launches
        out = k["wrapper"](x, *params, **kwargs)
        torch.cuda.synchronize()
        if k["wrapper"].launches != before + 1:
            raise AssertionError("kernel 3 did not launch at SCRATCH_BLOCK")
        worst = {}
        for i in (0, B - 1):
            args = [x[i:i + 1], *params]
            args[5] = params[4][i:i + 1]  # this sample's FiLM
            res = check(f"resnet_block {SCRATCH_BLOCK} sample {i}", out[i:i + 1],
                        k["plain"](*args, **kwargs), BF16_REL_TOL,
                        k["residual"](*args, **kwargs))
            worst = max(worst, res, key=lambda d: d.get("max_abs_err", -1.0))
        ms = cuda_ms(lambda: k["wrapper"](x, *params, **kwargs), 3)
    log({"kernel": "resnet_block", "shape": [B, T, H, W, C], "cout": cout, "groups": groups,
         "dtype": "bfloat16", "scratch_bytes": nbytes, "kernel_ms": ms,
         "check": "kernel 3 with a scratch over 2 GiB, samples 0 and B-1 vs plain", **worst,
         "card": card})
    del x, out
    torch.cuda.empty_cache()


def stw_bwd_plan_phase():
    """Kernel 5's plan at every width its bf16 body takes: the source's
    layout (the stw_bwd_smem query) fits one block with a ring of two or
    more stages."""
    from extdm_tpu_torch.ops import fused_stw

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = {}
    for C in range(32, fused_stw.MAX_WIDE_CHANNELS + 1, 32):
        for heads in (4, 8):
            plan = fused_stw.stw_bwd_plan(C, 64, heads, 32, sms)
            if not (2 <= plan.stages and plan.smem <= fused_stw.STW_SMEM_MAX):
                raise AssertionError(f"stw_bwd_plan({C}, heads={heads}): {plan}")
            plans[f"{C}/{heads}"] = [plan.stages, plan.smem]
    log({"check": "kernel 5's plan fits at every width (C/heads: [stages, smem])",
         "plans": plans})


def stw_bwd_ragged_phase(btable, card, seed=19):
    """Kernel 5 (bf16) against its plain backward at STW_RAGGED (96, 128,
    192 and 320 channels, windows clamped to 16 and 32 tokens, shifted and
    unshifted), with the backward limits; timed."""
    from extdm_tpu_torch.nn.attention import get_window_size

    k = btable["stw_layer_bwd"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s, scale=1.0: torch.randn(s, generator=g, device="cuda") * scale  # noqa: E731
    heads, dh = 8, 32
    hid = heads * dh
    for shape, shift0 in STW_RAGGED:
        C = shape[-1]
        window, shift = get_window_size(shape[1:4], (4, 4, 4), shift0)
        N = math.prod(window)
        args = [r(*shape).bfloat16(), r(*shape).bfloat16(), 1 + r(C, scale=0.1),
                r(3 * hid, C, scale=C ** -0.5).bfloat16(), r(C, hid, scale=hid ** -0.5).bfloat16(),
                r(C, scale=0.1).bfloat16(), r(heads, N, N, scale=0.1)]
        kwargs = dict(window=window, shift=shift, heads=heads, dim_head=dh)
        res = check_grads(f"stw_layer_bwd ragged {shape}", k["wrapper"](*args, **kwargs),
                          k["plain"](*args, **kwargs), BWD_MAX_REL_TOL, BWD_MEAN_REL_TOL)
        ms = cuda_ms(lambda: k["wrapper"](*args, **kwargs), 5)
        log({"kernel": "stw_layer_bwd", "shape": list(shape), "window": list(window),
             "shift": list(shift), "tokens": N, "dtype": "bfloat16", "kernel_ms": ms,
             "check": "kernel 5 vs plain backward at a ragged shape", **res, "card": card})


def resnet_bwd_ragged_phase(btable, card, seed=31):
    """Kernel 7 (bf16) against its plain backward at RESNET_RAGGED (frames
    off the 128-row tiles, Cin != Cout with the residual projection,
    channels off 16-byte rows and 4 groups; with and without FiLM), with the
    backward limits, twice for bitwise equal gradients; timed."""
    k = btable["resnet_block_bwd"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s, scale=1.0: torch.randn(s, generator=g, device="cuda") * scale  # noqa: E731
    for i, (shape, cout, groups) in enumerate(RESNET_RAGGED):
        B, C = shape[0], shape[-1]
        args = [r(*shape).bfloat16(), r(cout, C, 1, 3, 3, scale=(9 * C) ** -0.5),
                r(cout, scale=0.1), 1 + r(cout, scale=0.1), r(cout, scale=0.1),
                r(B, 2 * cout, scale=0.3) if i % 2 == 0 else None,
                r(cout, cout, 1, 3, 3, scale=(9 * cout) ** -0.5), r(cout, scale=0.1),
                1 + r(cout, scale=0.1), r(cout, scale=0.1)]
        args += [r(cout, C, 1, 1, 1, scale=C ** -0.5), r(cout, scale=0.1)] if C != cout else [
            None, None]
        gg = r(*shape[:-1], cout).bfloat16()
        kwargs = dict(groups=groups)
        got = k["wrapper"](gg, *args, **kwargs)
        repeat_check("resnet_block_bwd ragged", shape, got, k["wrapper"](gg, *args, **kwargs))
        res = check_grads(f"resnet_block_bwd ragged {shape} -> {cout}", got,
                          k["plain"](gg, *args, **kwargs), BWD_MAX_REL_TOL, BWD_MEAN_REL_TOL)
        ms = cuda_ms(lambda: k["wrapper"](gg, *args, **kwargs), 5)
        log({"kernel": "resnet_block_bwd", "shape": list(shape), "cout": cout, "groups": groups,
             "film": args[5] is not None, "dtype": "bfloat16", "kernel_ms": ms,
             "check": "kernel 7 vs plain backward at a ragged shape, bitwise equal on repeat",
             **res, "card": card})


def parent_body_ms(k, args, kwargs, reps):
    """Device time of the parent's body of kernel 2 or 6 (``parent`` in the
    table: attention.cu / attention_bwd.cu) on the same inputs, or None where
    it does not take the layer (over 256 channels)."""
    from extdm_tpu_torch.ops import fused_stw

    x = args[1] if torch.is_tensor(args[1]) and args[1].ndim == 5 else args[0]
    if "parent" not in k or x.shape[-1] > fused_stw.MAX_CHANNELS:
        return None
    return device_ms(lambda: k["parent"](*args, **kwargs), reps,
                     kernel_symbols(k["parent_source"]))[0]


# Backward kernels checked twice on the same inputs for bitwise equal gradients
# (kernel 8: d_grid; its d_image's global sums vary below float32 resolution).
REPEATS = ("temporal_layer_bwd", "resnet_block_bwd", "grid_sample_bwd")


def repeat_check(name, key, first, again):
    """A backward kernel twice on the same inputs: every gradient the same
    bit for bit (partials added in a fixed order, no atomics across threads
    on one element)."""
    if not all(torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))
               for a, b in zip(first, again) if a is not None):
        raise AssertionError(f"{name}{key}: two launches on the same inputs differ")


# Kernels 2 and 6 (bf16) at temporal layers off the presets': T not filling
# the tile's 32 frame slots (7, 10, 20: one or two 16-row tiles of a
# sequence live), widths not a multiple of 128 (96, 192, 320: ragged column
# rounds and 64-channel blocks), 4 and 8 heads, 3 x 5 and 4 x 4 frames (an
# odd number of sequences leaves a tile's second sequence empty), batch 1-2.
# (shape, heads)
TEMPORAL_RAGGED = (((1, 7, 3, 5, 96), 4), ((2, 10, 4, 4, 192), 8), ((2, 20, 3, 5, 320), 4),
                   ((1, 20, 4, 4, 320), 8), ((2, 7, 4, 4, 192), 4))


def temporal_ragged_phase(card, seed=29):
    """Kernels 2 and 6 (bf16) against their plain versions at TEMPORAL_RAGGED
    (the branch check and the backward limits), kernel 6 twice for bitwise
    equal gradients, timed; and the operands both entries write first
    (``fused_stw.temporal_operands``, parameters in float32 and in bf16)
    against their plain version, exactly."""
    from extdm_tpu_torch.nn.layers import chan_layer_norm
    from extdm_tpu_torch.ops import fused_stw

    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s, scale=1.0: torch.randn(s, generator=g, device="cuda") * scale  # noqa: E731
    dh = 32
    for (shape, heads), pdtype in zip(TEMPORAL_RAGGED, (torch.float32, torch.bfloat16) * 3):
        B, T, H, W, C = shape
        hid = heads * dh
        args = [r(*shape).bfloat16()] + [t.to(pdtype) for t in (
            1 + r(C, scale=0.1), 1 + r(C, scale=0.1), r(C, scale=0.1),
            r(3 * hid, C, scale=C ** -0.5), r(C, hid, scale=hid ** -0.5),
            r(heads, T, T, scale=0.1))]
        kwargs = dict(heads=heads, dim_head=dh)
        ops = fused_stw.temporal_operands(*args[4:6], *args[1:4], args[6])
        want_ops = fused_stw.temporal_operands_plain(*args[4:6], *args[1:4], args[6])
        if not all(torch.equal(ops[n], want_ops[n]) for n in want_ops):
            raise AssertionError(f"temporal operands {shape} ({pdtype}): card and plain differ")
        with torch.no_grad():
            res = check(f"temporal_layer ragged {shape}", fused_stw.fused_temporal_layer(
                *args, **kwargs), fused_stw.temporal_layer_plain(*args, **kwargs), BF16_REL_TOL,
                args[0].float() + chan_layer_norm(args[0], args[1]).float())
            ms = cuda_ms(lambda: fused_stw.fused_temporal_layer(*args, **kwargs), 10)
        gg = r(*shape).bfloat16()
        got = fused_stw.temporal_layer_bwd(gg, *args, **kwargs)
        repeat_check("temporal_layer_bwd ragged", shape, got,
                     fused_stw.temporal_layer_bwd(gg, *args, **kwargs))
        bres = check_grads(f"temporal_layer_bwd ragged {shape}", got,
                           fused_stw.temporal_layer_plain_vjp(gg, *args, **kwargs),
                           BWD_MAX_REL_TOL, BWD_MEAN_REL_TOL)
        bms = cuda_ms(lambda: fused_stw.temporal_layer_bwd(gg, *args, **kwargs), 5)
        log({"kernel": "temporal_layer", "shape": list(shape), "heads": heads,
             "params": str(pdtype).replace("torch.", ""), "dtype": "bfloat16", "kernel_ms": ms,
             "check": "kernel 2 vs plain at a ragged shape; its operands card vs plain, exact",
             **res, "card": card})
        log({"kernel": "temporal_layer_bwd", "shape": list(shape), "heads": heads,
             "dtype": "bfloat16", "kernel_ms": bms,
             "check": "kernel 6 vs plain backward at a ragged shape, bitwise equal on repeat",
             **bres, "card": card})


def kernel_phase(table, record, card):
    summary = {}
    for name, k in table.items():
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
                   library_ms=0.0 if name == "grid_sample" else None, max_abs_err=0.0)
        if name in DEVICE_TIMED:
            tot.update(device_ms=0.0, flops=0.0)
        if "parent" in k:
            tot.update(parent_device_ms=0.0)
        if name == "grid_sample":
            tot.update(library_device_ms=0.0, other_device_ms=0.0)
            log({"bound_model": WARP_BOUND_MODEL})
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
            if name in DEVICE_TIMED:  # the kernel's own device time
                dev_ms, other_ms = device_ms(lambda: k["wrapper"](*args, **kwargs), reps,
                                             kernel_symbols(k["source"]))
                line.update(kernel_device_ms=dev_ms, device_tflops=flops / dev_ms / 1e9,
                            bound_share=max(bytes_ms, ops_ms) / dev_ms)
                tot["device_ms"] += count * dev_ms
                tot["flops"] += count * flops
            if "parent" in k:
                line["parent_body_device_ms"] = parent_body_ms(k, args, kwargs, reps)
                tot["parent_device_ms"] += count * (line["parent_body_device_ms"] or 0.0)
            if name == "grid_sample":
                image = args[0].permute(0, 3, 1, 2)
                grid = args[1].to(image.dtype)
                mode = kwargs.get("padding_mode", "zeros")
                library = lambda: F.grid_sample(  # noqa: E731
                    image, grid, mode="bilinear", padding_mode=mode, align_corners=True)
                line["library_ms"] = cuda_ms(library, reps)
                line["library_device_ms"] = device_ms(library, reps)[0]
                line["wrapper_other_device_ms"] = other_ms
                tot["library_ms"] += count * line["library_ms"]
                tot["library_device_ms"] += count * line["library_device_ms"]
                tot["other_device_ms"] += count * other_ms
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

    stw_ragged_phase(table, card)
    resnet_ragged_phase(table, card)
    resnet_large_batch_phase(table, card)
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
def cond_stream_layers(cfg):
    """Temporal layers of the UNet's (x, t)-invariant conditioning stream:
    one in the adaptor family (run once a sampler call, as its cond cache),
    none in the trajwarp family (whose conditioning is TrajWarp, no kernel
    layer) or without reference features."""
    return int(cfg.use_ref_features and cfg.conditioning != "trajwarp")


def expected_launches(cfg):
    levels, steps = len(cfg.dim_mults), cfg.sampling_timesteps
    return {"stw_layer": steps * 2 * (2 * levels + 1),
            "temporal_layer": steps * (1 + 2 * levels) + cond_stream_layers(cfg),
            "resnet_block": steps * (4 * levels + 4),
            "grid_sample": 5}


def unet_f32_card_vs_cpu(cfg, what="unet3d"):
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
    res = check(f"{what} float32 card vs cpu", out_gpu, out_cpu, UNET_F32_REL_TOL)
    log({"check": f"{what} float32 batch 1, card kernels vs CPU plain",
         "shape": list(out_cpu.shape), "cpu_s": cpu_s, **res})


def backward_phase(table, record, card):
    """Backward kernels vs their plain versions at every recorded training
    shape (bf16) and at one small shape in float32; CUDA-event times."""
    summary = {}
    for name, k in table.items():
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
                   library_ms=None, max_abs_err=0.0)
        if name in DEVICE_TIMED:
            tot.update(device_ms=0.0, flops=0.0)
        if "parent" in k:
            tot.update(parent_device_ms=0.0)
        for key, entry in record[name].items():
            args, kwargs, count = entry["args"], entry["kwargs"], entry["count"]
            got = k["wrapper"](*args, **kwargs)
            want = k["plain"](*args, **kwargs)
            torch.cuda.synchronize()
            res = check_grads(f"{name}{key}", got, want, BWD_MAX_REL_TOL, BWD_MEAN_REL_TOL)
            if name in REPEATS:
                repeat_check(name, key, got, k["wrapper"](*args, **kwargs))
            ms = cuda_ms(lambda: k["wrapper"](*args, **kwargs), 5)
            plain_ms = cuda_ms(lambda: k["plain"](*args, **kwargs), 5)
            byts, flops, op_dtype = k["cost"](*args, **kwargs)
            bytes_ms, ops_ms = byts / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[op_dtype] * 1e3
            line = {"kernel": name, "shape": list(key[0]), "key": str(key[1:]),
                    "dtype": str(args[1].dtype).replace("torch.", ""), "per_step": count,
                    "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": None,
                    "library_ms_note": "no single PyTorch call computes this layer's gradients",
                    "bound_ms": max(bytes_ms, ops_ms),
                    "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", **res,
                    "card": card}
            if name in DEVICE_TIMED:  # the kernel's own device time
                dev_ms = device_ms(lambda: k["wrapper"](*args, **kwargs), 5,
                                   kernel_symbols(k["source"]))[0]
                line.update(kernel_device_ms=dev_ms, device_tflops=flops / dev_ms / 1e9,
                            bound_share=max(bytes_ms, ops_ms) / dev_ms)
                tot["device_ms"] += count * dev_ms
                tot["flops"] += count * flops
            if "parent" in k:
                line["parent_body_device_ms"] = parent_body_ms(k, args, kwargs, 5)
                tot["parent_device_ms"] += count * (line["parent_body_device_ms"] or 0.0)
            log(line)
            tot["ms"] += count * ms
            tot["plain_ms"] += count * plain_ms
            tot["bound_ms"] += count * max(bytes_ms, ops_ms)
            tot["bytes_ms"] += count * bytes_ms
            tot["ops_ms"] += count * ops_ms
            tot["max_abs_err"] = max(tot["max_abs_err"], res["max_abs_err"])
        summary[name] = tot

    stw_bwd_plan_phase()
    stw_bwd_ragged_phase(table, card)
    resnet_bwd_ragged_phase(table, card)
    temporal_ragged_phase(card)
    from resnet_bwd_split import split_lines
    split_lines(card)  # kernel 7's device time by kernel name, and the decomposed route's
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
    per_layer = {"stw_layer": 2 * (2 * levels + 1),
                 "temporal_layer": 1 + 2 * levels + cond_stream_layers(cfg),
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
    resnet_bwd_ab(record["resnet_block_bwd"], card)
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
    want = {**want_fwd, **want_bwd, **want_others}
    resnet_backward_step_ab(trainer, video, counters, want, card)
    del trainer, fd
    torch.cuda.empty_cache()
    train_f32_card_vs_cpu(cfg)
    return summary, launches, med * 1e3


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
    recorded AE-step shape (float32, and bf16 at the decode shapes), twice
    for a bitwise equal d_grid; CUDA-event and device times of kernel, plain
    version and ATen's call; then WARP_RAGGED."""
    name, k = "grid_sample_bwd", btable["grid_sample_bwd"]
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
               max_abs_err=0.0, device_ms=0.0, flops=0.0, library_device_ms=0.0,
               other_device_ms=0.0)
    symbols = kernel_symbols(k["source"])
    for key, entry in record[name].items():
        args, kwargs, count = entry["args"], entry["kwargs"], entry["count"]
        got = k["wrapper"](*args, **kwargs)
        want = k["plain"](*args, **kwargs)
        torch.cuda.synchronize()
        # relative to each gradient's own size: at batch 64 the decode warps'
        # d_image is ~1e-5, far under the max(1, .) floor of F32_REL_TOL
        res = check_grads(f"{name}{key}", got, want, F32_REL_TOL, F32_REL_TOL)
        if name in REPEATS:
            repeat_check(name, key, got[1:], k["wrapper"](*args, **kwargs)[1:])
        line = {"kernel": name, "shape": list(key[0]), "key": str(key[1:]), "dtype": "float32",
                "per_step": count, **res}
        if args[1].shape[-1] >= 67:  # the decode warps: the kernel serves bf16 images too
            g16, img16 = args[0].bfloat16(), args[1].bfloat16()
            res16 = check_grads(f"{name}{key} bf16", k["wrapper"](g16, img16, *args[2:], **kwargs),
                                k["plain"](g16, img16, *args[2:], **kwargs),
                                BWD_MAX_REL_TOL, BWD_MEAN_REL_TOL)
            line["bf16"] = res16
        ms = cuda_ms(lambda: k["wrapper"](*args, **kwargs), 5)
        dev_ms, other_ms = device_ms(lambda: k["wrapper"](*args, **kwargs), 5, symbols)
        plain_ms = cuda_ms(lambda: k["plain"](*args, **kwargs), 5)
        library = warp_bwd_library(*args, **kwargs)
        library_ms = cuda_ms(library, 5)
        library_dev_ms = device_ms(library, 5)[0]
        byts, flops, op_dtype = k["cost"](*args, **kwargs)
        bytes_ms, ops_ms = byts / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[op_dtype] * 1e3
        line.update(kernel_ms=ms, kernel_device_ms=dev_ms, wrapper_other_device_ms=other_ms,
                    bound_share=max(bytes_ms, ops_ms) / dev_ms, plain_ms=plain_ms,
                    library_ms=library_ms, library_device_ms=library_dev_ms,
                    library_call="aten.grid_sampler_2d_backward (NCHW-contiguous operands)",
                    bound_ms=max(bytes_ms, ops_ms),
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations", card=card)
        log(line)
        for field, value in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", library_ms),
                             ("bound_ms", max(bytes_ms, ops_ms)), ("bytes_ms", bytes_ms),
                             ("ops_ms", ops_ms), ("device_ms", dev_ms), ("flops", flops),
                             ("library_device_ms", library_dev_ms),
                             ("other_device_ms", other_ms)):
            tot[field] += count * value
        tot["max_abs_err"] = max(tot["max_abs_err"], res["max_abs_err"])
    # the padding modes the AE step does not differentiate through, float32
    # (d_grid by the TPU kernel's rules, warp_bwd_reference)
    gen = torch.Generator(device="cuda").manual_seed(9)
    for mode in WARP_MODES:
        image = torch.randn((2, 12, 16, 67), generator=gen, device="cuda")
        grid = torch.rand((2, 10, 14, 2), generator=gen, device="cuda") * 2.4 - 1.2
        g = torch.randn((2, 10, 14, 67), generator=gen, device="cuda")
        res = check_grads(f"{name} {mode} float32", k["wrapper"](g, image, grid, mode),
                          warp_bwd_reference(g, image, grid, mode), F32_REL_TOL, F32_REL_TOL)
        log({"kernel": name, "shape": list(image.shape), "padding_mode": mode, "dtype": "float32",
             "check": "kernel vs plain backward", **res})
    warp_ragged_phase(card)
    return {name: tot}


# Kernels 4 and 8 off the path's shapes: (C, image (B, H, W), output (Ho, Wo)).
# Output sizes that are no multiple of the tiles (4 x 8 to 16 x 16 pixels);
# every channel count's vector width (C = 1, 3, 5, 67: one element; 130: two
# bf16 / floats; 256, 512: 16 bytes) and lanes a pixel (1-32). Each on three
# grids (``warp_grid``): one that contracts (kernel 8's reductions collide
# on few pixels), a smooth one near scale 1 with points on the lines, and a
# uniform random one.
WARP_RAGGED = ((1, (2, 128, 96), (37, 45)), (3, (2, 72, 72), (33, 41)),
               (5, (2, 72, 72), (41, 29)), (67, (2, 40, 40), (21, 19)),
               (130, (2, 40, 40), (23, 30)), (256, (1, 40, 40), (19, 21)),
               (512, (1, 40, 40), (13, 17)))
# Normalised grid values on the clamp and fold lines: x = 0 and x = W - 1
# (-1, 1: the border clamp's ends; a reflection fold at W - 1), x = 2 (W - 1)
# and -2 (W - 1) (3, -5: the reflection's period), x = -(W - 1) (-3: onto
# the fold).
WARP_LINES = (-1.0, 1.0, 3.0, -3.0, -5.0)
WARP_BOUND_MODEL = {
    "grid_sample": "bytes: the image, the float32 grid and the output once",
    "grid_sample_bwd": "bytes: dout and the float32 grid read once, the image read once where "
                       "d_grid is asked for, d_image (the image's dtype) and the float32 d_grid "
                       "written once; the zero fill of d_image not counted"}


def warp_grid(g, kind, n, ho, wo):
    """(n, ho, wo, 2) float32: "affine", the identity through a seeded
    affine map that leaves the image a little, with every 7th point on a
    clamp or fold line (WARP_LINES) in x, every 11th in y; "contracting",
    the identity through a seeded affine map that shrinks it to about a
    third (a tile's corners fall in a box smaller than the tile, so that
    kernel 8's d_image reductions collide); or "uniform" in [-1.2, 1.2]."""
    if kind == "uniform":
        return torch.rand((n, ho, wo, 2), generator=g, device="cuda") * 2.4 - 1.2
    ys, xs = torch.meshgrid(torch.linspace(-1, 1, ho, device="cuda"),
                            torch.linspace(-1, 1, wo, device="cuda"), indexing="ij")
    ident = torch.stack([xs, ys], -1).reshape(1, ho * wo, 2)
    scale = 0.3 if kind == "contracting" else 1.05
    a = scale * torch.eye(2, device="cuda") + 0.1 * scale * torch.randn(
        (n, 2, 2), generator=g, device="cuda")
    t = 0.1 * torch.randn((n, 1, 2), generator=g, device="cuda")
    grid = (ident @ a.transpose(1, 2) + t).reshape(n, ho * wo, 2)
    if kind == "contracting":
        return grid.reshape(n, ho, wo, 2).contiguous()
    lines = torch.tensor(WARP_LINES, device="cuda")
    i = torch.arange(ho * wo, device="cuda")
    grid[:, i % 7 == 0, 0] = lines[(i[i % 7 == 0] // 7) % len(WARP_LINES)]
    grid[:, i % 11 == 0, 1] = lines[(i[i % 11 == 0] // 11) % len(WARP_LINES)]
    return grid.reshape(n, ho, wo, 2).contiguous()


def warp_bwd_reference(g, image, grid, padding_mode="zeros"):
    """What kernel 8 is held to off the path: the plain backward's d_image
    and, for d_grid, ``grid_sample_dgrid_plain``, which takes the TPU
    kernel's rules on the clamp and fold lines (where the plain backward's
    autograd differs: a border bound, a reflection fold); off the lines the
    two d_grids agree (tests/test_torch_warp_plan.py holds both against the
    JAX package's Pallas backward)."""
    from extdm_tpu_torch.ops import fused_warp

    d_image = fused_warp.grid_sample_plain_vjp(g, image, grid, padding_mode)[0]
    return d_image, fused_warp.grid_sample_dgrid_plain(g, image, grid, padding_mode)


def check_nan(name, got, want, rel, mean_rel=None):
    """NaN where want is NaN, and check / check_grads on the rest."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a is not None and not torch.equal(torch.isnan(a), torch.isnan(b)):
            raise AssertionError(f"{name} output {i}: NaN at {int(torch.isnan(a).sum())} "
                                 f"places, the plain version at {int(torch.isnan(b).sum())}")
    clean = lambda ts: [None if t is None else t.nan_to_num(0.0) for t in ts]  # noqa: E731
    return check_grads(name, clean(got), clean(want), rel, mean_rel)


def warp_ragged_phase(card, seed=37):
    """Kernels 4 and 8 against their plain versions at WARP_RAGGED in float32
    and bf16, all three padding modes, on a contracting grid, a smooth
    affine one with points on the clamp and fold lines and a uniform random
    one, d_grid bitwise equal on repeat; then one NaN grid point (NaN where
    the plain version has NaN, the rest within the limits) and operands
    that start off a 16-byte boundary (the plan's narrower vectors). Kernel
    8's d_grid is held to ``warp_bwd_reference``. Each case also takes
    d_grid alone (kernel 8 without d_image, as the K+1 sparse warp calls
    it)."""
    from extdm_tpu_torch.ops import fused_warp

    g = torch.Generator(device="cuda").manual_seed(seed)
    cases = 0

    def one(what, image, grid, cot, mode, nan=False):
        nonlocal cases
        dtype = image.dtype
        f32 = dtype == torch.float32
        fwd_tol, bwd = (F32_REL_TOL, (F32_REL_TOL, F32_REL_TOL)) if f32 else (
            BF16_REL_TOL, (BWD_MAX_REL_TOL, BWD_MEAN_REL_TOL))
        out = fused_warp.grid_sample(image, grid, mode)
        want = fused_warp.grid_sample_plain(image, grid, mode)
        got_b = fused_warp.grid_sample_bwd(cot, image, grid, mode)
        want_b = warp_bwd_reference(cot, image, grid, mode)
        repeat_check("grid_sample_bwd", what, got_b[1:],
                     fused_warp.grid_sample_bwd(cot, image, grid, mode)[1:])
        # d_grid alone (the K+1 sparse warp's call): a pixel a thread where
        # a pixel's channels are few
        got_g = (None, fused_warp.grid_sample_bwd(cot, image, grid, mode, image_grad=False)[1])
        repeat_check("grid_sample_bwd d_grid alone", what, got_g[1:],
                     fused_warp.grid_sample_bwd(cot, image, grid, mode, image_grad=False)[1:])
        if nan:
            fres = check_nan(f"grid_sample {what}", [out], [want], fwd_tol)
            bres = check_nan(f"grid_sample_bwd {what}", got_b, want_b, *bwd)
            check_nan(f"grid_sample_bwd {what}, d_grid alone", got_g, (None, want_b[1]), *bwd)
        else:
            fres = check(f"grid_sample {what}", out, want, fwd_tol)
            bres = check_grads(f"grid_sample_bwd {what}", got_b, want_b, *bwd)
            check_grads(f"grid_sample_bwd {what}, d_grid alone", got_g, (None, want_b[1]), *bwd)
        plan = fused_warp.grid_sample_plan(*image.shape, *grid.shape[1:3], image.element_size(),
                                           fused_warp._align(image, cot),
                                           torch.cuda.get_device_properties(0).multi_processor_count,
                                           True)
        log({"kernel": "grid_sample", "check": f"kernels 4 and 8 vs plain, {what}",
             "shape": list(image.shape), "grid": list(grid.shape), "padding_mode": mode,
             "dtype": str(dtype).replace("torch.", ""), "forward": fres, "backward": bres,
             "bwd_vec": plan.vec, "bwd_lanes": plan.lanes, "bwd_tile": [plan.tile_h, plan.tile_w]})
        cases += 1

    for C, (B, H, W), (Ho, Wo) in WARP_RAGGED:
        for dtype in (torch.float32, torch.bfloat16):
            image = torch.randn((B, H, W, C), generator=g, device="cuda").to(dtype)
            cot = torch.randn((B, Ho, Wo, C), generator=g, device="cuda").to(dtype)
            for mode in WARP_MODES:
                for kind in ("contracting", "affine", "uniform"):
                    one(f"{kind} grid", image, warp_grid(g, kind, B, Ho, Wo), cot, mode)
    for C in (3, 67):
        for dtype in (torch.float32, torch.bfloat16):
            image = torch.randn((2, 24, 20, C), generator=g, device="cuda").to(dtype)
            cot = torch.randn((2, 17, 13, C), generator=g, device="cuda").to(dtype)
            grid = warp_grid(g, "affine", 2, 17, 13)
            grid[1, 5, 6, 0] = float("nan")
            for mode in WARP_MODES:
                one("one NaN grid point", image, grid, cot, mode, nan=True)
    for C, dtype in ((256, torch.bfloat16), (128, torch.float32), (130, torch.float32)):
        # views one element into their storage: 2 or 4 bytes off 16
        image = torch.randn((2 * 30 * 28 * C + 1,), generator=g, device="cuda").to(dtype)[1:]
        cot = torch.randn((2 * 21 * 19 * C + 1,), generator=g, device="cuda").to(dtype)[1:]
        image, cot = image.view(2, 30, 28, C), cot.view(2, 21, 19, C)
        for mode in WARP_MODES:
            one("operands off a 16-byte boundary", image, warp_grid(g, "affine", 2, 21, 19),
                cot, mode)
    log({"phase": "WARP_RAGGED", "cases": cases, "card": card})


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


def ae_model_and_trainer(cfg, device, seed=0, dtype=None, group=None):
    from extdm_tpu_torch.models.lfae.recon_model import ReconstructionModel
    from extdm_tpu_torch.train.ae_trainer import AETrainer, make_optimizer

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = ReconstructionModel(dtype=dtype, **cfg["model"])
    return AETrainer(model, make_optimizer(cfg["lr"], cfg["milestones"], cfg["gamma"]),
                     device_augment=cfg["device_augment"], device=device, group=group)


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
    return summary, launches, med * 1e3


# ------------------------------------------------------------ training jobs
@contextlib.contextmanager
def per_call_launches(owner, attr, counters, calls, before_first=None, factory=False):
    """owner.attr (a method; with `factory`, a method whose result is the
    callable to count) wrapped: each call appends its launches of every
    counter to `calls`; `before_first(args)` runs before the first."""
    orig = getattr(owner, attr)

    def counted(fn):
        def call(*args, **kwargs):
            if before_first is not None and not calls:
                before_first(args)
            start = {n: c.launches for n, c in counters.items()}
            out = fn(*args, **kwargs)
            calls.append({n: c.launches - start[n] for n, c in counters.items()})
            return out
        return call

    if factory:
        setattr(owner, attr, lambda *a, **k: counted(orig(*a, **k)))
    else:
        setattr(owner, attr, counted(orig))
    try:
        yield
    finally:
        setattr(owner, attr, orig)


def job_defaults():
    """PyTorch's TF32 defaults, which a job runs under (and the bare steps
    of the train and AE phases); the card-vs-CPU checks before turn TF32
    off."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False


def job_yaml(src, tmp, section, **train_params):
    """A copy of a repository yaml in `tmp` with the train_params of
    `section` ("diffusion_params" or "flow_params") overridden."""
    import yaml

    cfg = yaml.safe_load(open(Path(__file__).resolve().parent / src))
    cfg[section]["train_params"].update(train_params)
    path = Path(tmp) / Path(src).name
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def job_records(log_dir):
    return [json.loads(line) for line in open(Path(log_dir) / "metrics.jsonl")]


def check_job_run(log_dir, loss_key, steps, files, best_prefix):
    """The records and files of one job run: one loss record a step (each
    loss finite), the artefacts in `files` and a gated best checkpoint."""
    recs = job_records(log_dir)
    losses = [r for r in recs if loss_key in r]
    if [r["step"] for r in losses] != list(steps):
        raise AssertionError(f"{log_dir}: loss records at {[r['step'] for r in losses]}, "
                             f"want {list(steps)}")
    skip = {"step", "time", "batch_time", "data_time"}
    for r in losses:
        bad = {k: v for k, v in r.items() if k not in skip and not math.isfinite(v)}
        if bad:
            raise AssertionError(f"{log_dir} step {r['step']}: non-finite {bad}")
    have = {str(p.relative_to(log_dir)) for p in Path(log_dir).rglob("*") if p.is_file()}
    missing = [f for f in files if not any(Path(h).match(f) for h in have)]
    best = f"{best_prefix}*_best_*.ckpt"
    if missing or best_prefix and not any(Path(h).match(best) for h in have):
        raise AssertionError(f"{log_dir}: missing {missing or best}; has {sorted(have)}")
    return recs


def job_timing(recs, bare_step_ms):
    """The job's timing line: ms per step (median of batch_time, the run's
    first step, its warm-up, dropped), data wait, and the seconds of each
    validation, shot and checkpoint write, from its metrics.jsonl."""
    steps = [r for r in recs if "batch_time" in r][1:]
    pick = lambda k: [r[k] for r in recs if k in r]  # noqa: E731
    return {"job_ms_per_step": statistics.median(r["batch_time"] for r in steps) * 1e3,
            "job_ms_per_step_all": [r["batch_time"] * 1e3 for r in steps],
            "bare_step_median_ms": bare_step_ms,
            "data_time_ms": statistics.median(r["data_time"] for r in steps) * 1e3,
            "valid_seconds": pick("valid_seconds"), "shot_seconds": pick("shot_seconds"),
            "ckpt_seconds": pick("ckpt_seconds")}


def same_state(what, module_state, saved, opt, saved_opt):
    """A resumed trainer's parameters and optimizer moments, before its first
    update, against its checkpoint's."""
    for k, v in saved.items():
        if not torch.equal(module_state[k].detach().cpu(), v):
            raise AssertionError(f"{what}: resumed {k} differs from the checkpoint")
    state = opt.opt.state_dict()["state"]
    if state.keys() != saved_opt["state"].keys() or opt.count != saved_opt["count"]:
        raise AssertionError(f"{what}: resumed optimizer state keys or count differ")
    for i, s in state.items():
        for k, v in s.items():
            if not torch.equal(v.cpu(), saved_opt["state"][i][k]):
                raise AssertionError(f"{what}: resumed optimizer {i}.{k} differs")


def dm_job_phase(counters, card, bare_step_ms):
    """The DM training job (train/train_dm.py main) in-process on the card:
    configs/DM/kth.yaml at full width in bf16, batch 8 of in-memory
    moving-shapes videos, every cadence at 1 or 2 (a copy of the yaml), the
    LFAE random; 4 steps with validation at step 2, then a --set_start
    resume to step 6. Checks the launches of every train step and sampler
    call, the resumed state, the records and artefacts, and that
    eval/valid_dm.load_weights reads the checkpoint."""
    import tempfile

    from extdm_tpu_torch.config import dm_config_from_yaml, load_config
    from extdm_tpu_torch.eval.valid_dm import load_weights
    from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusion
    from extdm_tpu_torch.train import checkpoint, train_dm
    from extdm_tpu_torch.train.dm_trainer import DMTrainer

    t_phase = time.perf_counter()
    job_defaults()
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = job_yaml("configs/DM/kth.yaml", tmp, "diffusion_params", print_freq=1,
                            update_ckpt_freq=2, save_img_freq=2, save_vid_freq=2,
                            dataloader_workers=4)
        cfg = dm_config_from_yaml(load_config(cfg_path), dtype=torch.bfloat16)
        fwd, bwd = expected_train_launches(cfg)
        want_step = {n: {**fwd, **bwd}.get(n, 0) for n in counters}
        want_call = {n: expected_launches(cfg).get(n, 0) for n in counters}
        common = ["--config", cfg_path, "--bf16", "--batch_size", "8", "--synthetic_videos", "8",
                  "--valid_every", "2", "--valid_videos", "4", "--device", "cuda"]
        runs = []
        for i, extra in enumerate((["--max_steps", "4"],
                                   ["--max_steps", "6", "--set_start", "--checkpoint",
                                    str(Path(tmp) / "run0" / train_dm.CKPT)])):
            log_dir = str(Path(tmp) / f"run{i}")
            steps, calls, shots = [], [], []
            check = None
            if i:
                saved = checkpoint.load_checkpoint(extra[-1])

                def check(args, saved=saved):
                    trainer = args[0]
                    unet = {f"denoise_fn.{k}": v for k, v in trainer.fd.unet.state_dict().items()}
                    same_state("DM job resume", unet, saved["diffusion"], trainer.optimizer,
                               saved["optimizer"])
            for c in counters.values():
                c.launches = 0
            t0 = time.perf_counter()
            with per_call_launches(DMTrainer, "train_step", counters, steps, check), \
                    per_call_launches(FlowDiffusion, "make_sampler", counters, calls,
                                      factory=True), \
                    per_call_launches(FlowDiffusion, "make_monitor", counters, shots,
                                      factory=True):
                train_dm.main(common + extra + ["--log_dir", log_dir])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            first = 4 * i
            recs = check_job_run(log_dir, "loss", range(first, first + 4 - 2 * i),
                                 ["train.log", "metrics.jsonl", train_dm.CKPT, "imgshots/*.png",
                                  "vidshots/*.gif"], "flowdiff")
            if not steps or any(s != want_step for s in steps):
                raise AssertionError(f"DM job run {i}: step launches {steps} != {want_step}")
            if not calls or any(c != want_call for c in calls):
                raise AssertionError(f"DM job run {i}: sampler launches {calls} != {want_call}")
            if "at step 4" not in (Path(log_dir) / "train.log").read_text() and i:
                raise AssertionError("DM job: the resumed run did not start at step 4")
            runs.append(dict(job_timing(recs, bare_step_ms), run=i, seconds=seconds,
                             steps=len(steps), sampler_calls=len(calls),
                             monitor_launches=[{n: c for n, c in m.items() if c} for m in shots]))
            ckpt = Path(log_dir) / train_dm.CKPT
        fd = FlowDiffusion(cfg, device="cuda")
        load_weights(fd, "", str(ckpt))
        saved = checkpoint.load_checkpoint(str(ckpt))
        if saved["step"] != 6 or saved["optimizer"]["count"] != 6:
            raise AssertionError(f"DM job: final checkpoint at step {saved['step']}")
        for k, v in fd.unet.state_dict().items():
            if not torch.equal(v.cpu(), saved["diffusion"][f"denoise_fn.{k}"]):
                raise AssertionError(f"DM job: load_weights read {k} wrong")
        del fd
    torch.cuda.empty_cache()
    for r in runs:
        log({"phase": "DM job", "config": "configs/DM/kth.yaml, bf16, batch 8, 8 in-memory "
             "videos, random LFAE", "launches_per_step": want_step,
             "launches_per_sampler_call": want_call, **r, "card": card})
    log({"phase": "DM job phase", "seconds": time.perf_counter() - t_phase})


def ae_job_yaml(tmp):
    """The AE jobs' copy of configs/AE/kth.yaml: every cadence at 1 or 2,
    num_repeats 8 (an epoch of 8 videos is one batch of 64), 8 workers."""
    return job_yaml("configs/AE/kth.yaml", tmp, "flow_params", print_freq=1, update_ckpt_freq=2,
                    save_img_freq=2, num_repeats=8, dataloader_workers=8)


def ae_job_args(cfg_path):
    return ["--config", cfg_path, "--batch_size", "64", "--synthetic_videos", "8", "--device",
            "cuda"]


def ae_job_phase(counters, card, bare_step_ms):
    """The AE training job (train/train_ae.py main) in-process on the card:
    configs/AE/kth.yaml at full width (float32), batch 64 of raw uint8 pairs
    from 8 in-memory videos (num_repeats 8 in the yaml's copy, so an epoch
    is one batch) with --device_augment, every cadence at 1 or 2; 4 steps
    with validation at step 2, a --set_start resume to step 6, two steps with
    host augmentation (data/augmentation.py, numpy), and eval/valid_ae on the
    checkpoint. Checks launches per step, the resumed state, the records and
    artefacts."""
    import tempfile

    from extdm_tpu_torch.eval import valid_ae
    from extdm_tpu_torch.train import checkpoint, train_ae
    from extdm_tpu_torch.train.ae_trainer import AETrainer

    t_phase = time.perf_counter()
    job_defaults()
    want_step = {n: {"grid_sample": 6, "grid_sample_bwd": 5}.get(n, 0) for n in counters}
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = ae_job_yaml(tmp)
        common = ae_job_args(cfg_path) + ["--valid_every", "2", "--valid_videos", "4",
                                          "--valid_batch_size", "4"]
        ckpt0 = str(Path(tmp) / "run0" / train_ae.CKPT)
        plan = ((["--device_augment", "--max_steps", "4"], range(0, 4), True),
                (["--device_augment", "--max_steps", "6", "--set_start", "--checkpoint", ckpt0],
                 range(4, 6), True),
                (["--max_steps", "2", "--valid_every", "0"], range(0, 2), False))
        for i, (extra, steps_want, full) in enumerate(plan):
            log_dir = str(Path(tmp) / f"run{i}")
            steps, check = [], None
            if "--checkpoint" in extra:
                saved = checkpoint.load_checkpoint(ckpt0)

                def check(args, saved=saved):
                    trainer = args[0]
                    parts = {f"{p}.{k}": v for p in checkpoint.AE_PARTS + ("vgg",)
                             for k, v in saved[p].items()}
                    same_state("AE job resume", trainer.model.state_dict(), parts,
                               trainer.optimizer, saved["optimizer"])
            for c in counters.values():
                c.launches = 0
            t0 = time.perf_counter()
            with per_call_launches(AETrainer, "train_step", counters, steps, check):
                train_ae.main(common + extra + ["--log_dir", log_dir])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            files = ["train.log", "metrics.jsonl", train_ae.CKPT] + (
                ["imgshots/*.png"] if full else [])
            recs = check_job_run(log_dir, "loss_total", steps_want, files,
                                 "RegionMM" if full else "")
            if not steps or any(s != want_step for s in steps):
                raise AssertionError(f"AE job run {i}: step launches {steps} != {want_step}")
            if "--checkpoint" in extra and "at step 4" not in (
                    Path(log_dir) / "train.log").read_text():
                raise AssertionError("AE job: the resumed run did not start at step 4")
            runs.append(dict(job_timing(recs, bare_step_ms), run=i, seconds=seconds,
                             steps=len(steps), device_augment=full))
        out = Path(tmp) / "valid_ae"
        t0 = time.perf_counter()
        valid_ae.main(["--config", cfg_path, "--checkpoint", str(Path(tmp) / "run1" /
                                                                train_ae.CKPT),
                       "--synthetic_videos", "4", "--batch_size", "4", "--log_dir", str(out),
                       "--device", "cuda"])
        res = json.loads((out / "metrics.json").read_text())
        if not all(math.isfinite(float(v)) for v in res.values()):
            raise AssertionError(f"valid_ae: {res}")
        valid_seconds = time.perf_counter() - t0
    torch.cuda.empty_cache()
    for r in runs:
        log({"phase": "AE job", "config": "configs/AE/kth.yaml, float32, batch 64, 8 in-memory "
             "videos x 8 repeats", "launches_per_step": want_step, **r, "card": card})
    log({"phase": "valid_ae", "seconds": valid_seconds, **res, "card": card})
    log({"phase": "AE job phase", "seconds": time.perf_counter() - t_phase})


def first_batches(loader, n):
    """The first n batches of a loader, over as many epochs as that takes."""
    out = []
    while len(out) < n:
        for batch in loader:
            out.append(batch)
            if len(out) == n:
                break
    return out


def data_feed_phase(counters, card, dm_bare_ms, ae_bare_ms):
    """The rest of the data feed on the card: the AE job with host
    augmentation on ae_job_yaml's copy, 2 steps with --loader process and 2
    with --loader thread (the steps' launches equal, each run's data wait and
    ms per step beside the bare step's and the host's cores), then 30 steps
    each at 64 repeats (8 batches an epoch); the first two
    batches the process loader ships to the card against a process loader
    with device=None on the same seed, bitwise; the DM job 2 steps with
    --loader process. Without h5py (the card's machine) HDF5VideoStore and
    HDF5VideoWriter must raise an ImportError naming it; with h5py the DM job
    also runs on a store written by write_video_hdf5 with --clip_cache_mb and
    its prefill seconds are printed."""
    import os
    import tempfile

    import numpy as np

    from extdm_tpu_torch import data
    from extdm_tpu_torch.config import dm_config_from_yaml, load_config
    from extdm_tpu_torch.train import train_ae, train_dm
    from extdm_tpu_torch.train.ae_trainer import AETrainer
    from extdm_tpu_torch.train.dm_trainer import DMTrainer
    from extdm_tpu_torch.train.job import synthetic_stores

    t_phase = time.perf_counter()
    job_defaults()
    cores = len(os.sched_getaffinity(0))
    try:
        import h5py  # noqa: F401
        have_h5py = True
    except ImportError:
        have_h5py = False
    log({"phase": "data feed", "h5py": "present: the DM job on HDF5 shards with --clip_cache_mb"
         if have_h5py else "absent: HDF5VideoStore and HDF5VideoWriter must raise ImportError",
         "host_cores": cores})
    with tempfile.TemporaryDirectory() as tmp:
        # the AE job, host augmentation, process workers then threads: on
        # ae_job_yaml's copy (one batch an epoch: the loop restarts the loader
        # every step) and at 8 repeats more (8 batches an epoch, which process
        # workers build side by side), for 30 steps: the loaders fill their
        # prefetch queues during step 0's warm-up, so a few steps more would
        # read those batches and not the loaders' rate
        ae_cfg = ae_job_yaml(tmp)
        wide_dir = Path(tmp) / "epoch8"
        wide_dir.mkdir()
        wide_cfg = job_yaml("configs/AE/kth.yaml", wide_dir, "flow_params", print_freq=1,
                            update_ckpt_freq=100, save_img_freq=0, num_repeats=64,
                            dataloader_workers=8)
        want_ae = {n: {"grid_sample": 6, "grid_sample_bwd": 5}.get(n, 0) for n in counters}
        for cfg_path, repeats, n_steps in ((ae_cfg, 8, 2), (wide_cfg, 64, 30)):
            ae_steps = {}
            for loader in ("process", "thread"):
                log_dir = str(Path(tmp) / f"ae_{loader}_{repeats}")
                steps = []
                for c in counters.values():
                    c.launches = 0
                t0 = time.perf_counter()
                with per_call_launches(AETrainer, "train_step", counters, steps):
                    train_ae.main(ae_job_args(cfg_path) + [
                        "--max_steps", str(n_steps), "--valid_every", "0", "--loader", loader,
                        "--log_dir", log_dir])
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                recs = check_job_run(log_dir, "loss_total", range(n_steps),
                                     ["train.log", "metrics.jsonl", train_ae.CKPT], "")
                if steps != [want_ae] * n_steps:
                    raise AssertionError(f"AE job --loader {loader}: step launches {steps}")
                ae_steps[loader] = steps
                log({"phase": "data feed AE job", "loader": loader,
                     "config": f"configs/AE/kth.yaml, float32, batch 64, 8 in-memory videos x "
                     f"{repeats} repeats, host augmentation", "batches_an_epoch": repeats // 8,
                     **job_timing(recs, ae_bare_ms), "seconds": seconds, "host_cores": cores,
                     "launches_per_step": want_ae, "card": card})
            if ae_steps["process"] != ae_steps["thread"]:
                raise AssertionError(f"AE job launches: process {ae_steps['process']} != thread "
                                     f"{ae_steps['thread']}")

        # the batches the process loader ships against its numpy batches
        cfg = load_config(ae_cfg)
        dp, tp = cfg["dataset_params"], cfg["flow_params"]["train_params"]
        store = synthetic_stores(8, max(dp["max_frame_distance"] + 1, 16),
                                 dp["valid_params"]["cond_frames"]
                                 + dp["valid_params"]["pred_frames"], dp["frame_shape"],
                                 1234)["train"]
        shipped = []
        for device in ("cuda", None):
            ds = data.DatasetRepeater(data.TwoFramesDataset(
                store, type="train", frame_shape=dp["frame_shape"],
                min_frame_distance=dp.get("min_frame_distance", 0),
                max_frame_distance=dp["max_frame_distance"],
                augmentation_params=dp["augmentation_params"], seed=1234), tp["num_repeats"])
            loader = data.DataLoader(ds, 64, num_workers=tp["dataloader_workers"], seed=1234,
                                     prefetch=3, device=device, worker_type="process")
            with contextlib.closing(loader):
                shipped.append(first_batches(loader, 2))
        for i, (card_batch, host_batch) in enumerate(zip(*shipped)):
            for k, v in host_batch.items():
                t = card_batch[k]
                if not t.is_cuda or not torch.equal(t.cpu(), torch.from_numpy(v)):
                    raise AssertionError(f"shipped batch {i} {k!r} differs from the CPU "
                                         "process loader's")
        log({"phase": "data feed shipped batches", "batches": 2, "keys": sorted(shipped[1][0]),
             "bitwise_equal": True})

        # the DM job on process workers (and on HDF5 shards with the clip cache)
        dm_dir = Path(tmp) / "dm"
        dm_dir.mkdir()
        dm_cfg = job_yaml("configs/DM/kth.yaml", dm_dir, "diffusion_params", print_freq=1,
                          update_ckpt_freq=100, save_img_freq=0, save_vid_freq=0,
                          dataloader_workers=4)
        fwd, bwd = expected_train_launches(dm_config_from_yaml(load_config(dm_cfg),
                                                               dtype=torch.bfloat16))
        want_dm = {n: {**fwd, **bwd}.get(n, 0) for n in counters}
        common = ["--config", dm_cfg, "--bf16", "--batch_size", "8", "--max_steps", "2",
                  "--valid_every", "0", "--loader", "process", "--device", "cuda"]
        runs = [("memory", ["--synthetic_videos", "8"])]
        if have_h5py:
            dm = dm_config_from_yaml(load_config(dm_cfg))
            rng = np.random.RandomState(1234)
            nf = dm.cond_frames + dm.pred_frames
            data.write_video_hdf5([data.make_moving_shapes_video(rng, nf + 8, dm.frame_shape)
                                   for _ in range(8)], str(Path(tmp) / "shards" / "train"))
            runs.append(("hdf5", ["--root_dir", str(Path(tmp) / "shards"),
                                  "--clip_cache_mb", "64"]))
        else:
            for cls in (data.HDF5VideoStore, data.HDF5VideoWriter):
                try:
                    cls(tmp)
                except ImportError as e:
                    if "h5py" not in str(e):
                        raise AssertionError(f"{cls.__name__}: {e} does not name h5py") from e
                else:
                    raise AssertionError(f"{cls.__name__} opened without h5py")
            log({"phase": "data feed h5py", "import_error_names_h5py": True})
        for name, extra in runs:
            log_dir = str(Path(tmp) / f"dm_{name}")
            steps = []
            for c in counters.values():
                c.launches = 0
            t0 = time.perf_counter()
            with per_call_launches(DMTrainer, "train_step", counters, steps):
                train_dm.main(common + extra + ["--log_dir", log_dir])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            recs = check_job_run(log_dir, "loss", range(2),
                                 ["train.log", "metrics.jsonl", train_dm.CKPT], "")
            if steps != [want_dm] * 2:
                raise AssertionError(f"DM job --loader process ({name}): step launches {steps}")
            prefill = re.search(r"clip cache prefilled: (\d+) videos in ([\d.]+)s",
                                (Path(log_dir) / "train.log").read_text())
            if (prefill is None) == (name == "hdf5"):
                raise AssertionError(f"DM job ({name}): clip cache line {prefill}")
            log({"phase": "data feed DM job", "loader": "process", "data": name,
                 "config": "configs/DM/kth.yaml, bf16, batch 8, 8 videos, random LFAE",
                 **job_timing(recs, dm_bare_ms), "seconds": seconds, "host_cores": cores,
                 **({"prefill_videos": int(prefill[1]), "prefill_seconds": float(prefill[2])}
                    if prefill else {}), "launches_per_step": want_dm, "card": card})
    torch.cuda.empty_cache()
    log({"phase": "data feed phase", "seconds": time.perf_counter() - t_phase, "card": card})


# ---------------------------------------------------------------- artefacts
ARTEFACT_VIDEOS, ARTEFACT_TRAJ = 2, 2
# Kernel-4 launches: one LFAE encode_video runs one warp (the flow
# predictor's sparse-motion warp, models/lfae/pixelwise_flow.py:75); with
# with_decode (video2video) four more in the generator's decode (the full
# resolution skip and source in one, the bottleneck, the two up-block skips).
GT_FLOW_WARPS, TRANSFER_WARPS = 1, 5


@contextlib.contextmanager
def plain_sites(k):
    """Every call site of kernel table entry `k` on its plain version."""
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr in k["sites"]]
    for mod, attr, _ in saved:
        setattr(mod, attr, k["plain"])
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def artefacts_phase(table, counters, card):
    """The evaluation artefacts and tools on the card, configs/DM/kth.yaml at
    full width with the port's seeded weights (float32, valid_dm's dtype),
    TF32 off: valid_dm.main on ARTEFACT_VIDEOS synthetic videos x
    ARTEFACT_TRAJ trajectories with --dump_arrays --dump_flow --metrics
    psnr,ssim (the files; origin_flows.npy's first video against the LFAE's
    plain encode on the CPU with the same weights; kernel 4's launches in
    the GT-flow encode, GT_FLOW_WARPS a batch; each sampler call's launches;
    the seconds of the gif, the arrays and the pngs); analyze_dumps on those
    dumps (all four metrics, the CSV and the gif grids: its seconds);
    video2video on 3 synthetic videos (its transfer and flows against the
    same encode with kernel 4's sites on the plain version, on the card;
    TRANSFER_WARPS launches; ms per encode call); metrics.demo at the
    reference's 8 x 30 x 64^2 (each metric's seconds; PSNR and SSIM against
    the CPU's on the same videos). Returns the kernels' launches in the
    GT-flow encode and in video2video's encode."""
    import io
    import tempfile

    import numpy as np

    from extdm_tpu_torch.config import dm_config_from_yaml, load_config
    from extdm_tpu_torch.eval import analyze_dumps, valid_dm, video2video
    from extdm_tpu_torch.metrics import (I3DExtractor, LPIPSMetric, calculate_psnr1,
                                         calculate_ssim1, demo)
    from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusion

    t_phase = time.perf_counter()
    kth = str(Path(__file__).resolve().parent / "configs" / "DM" / "kth.yaml")
    cfg = dm_config_from_yaml(load_config(kth))
    vp = load_config(kth)["dataset_params"]["valid_params"]
    tc = vp["cond_frames"]
    zero = {n: 0 for n in counters}
    with tempfile.TemporaryDirectory() as tmp, tf32_off():
        # ---- valid_dm with every artefact
        log_dir = Path(tmp) / "valid"
        gt_calls, sampler_calls, seen = [], [], {}
        write = valid_dm.write_artefacts

        def writing(args, fd, out, tc_):
            seen["seconds"] = write(args, fd, out, tc_)
            return seen["seconds"]

        def grab(args):  # the LFAE and real videos of the GT-flow encode
            seen["lfae"], seen["real"] = copy.deepcopy(args[0].lfae).cpu(), args[1][:1].clone()

        for c in counters.values():
            c.launches = 0
        valid_dm.write_artefacts = writing
        t0 = time.perf_counter()
        try:
            with per_call_launches(valid_dm, "gt_flows", counters, gt_calls, before_first=grab), \
                    per_call_launches(FlowDiffusion, "make_sampler", counters, sampler_calls,
                                      factory=True):
                valid_dm.main(["--config", kth, "--synthetic_videos", str(ARTEFACT_VIDEOS),
                               "--num_sample_video", str(ARTEFACT_TRAJ), "--batch_size",
                               str(ARTEFACT_VIDEOS), "--metrics", "psnr,ssim", "--dump_arrays",
                               "--dump_flow", "--log_dir", str(log_dir), "--device", "cuda"])
        finally:
            valid_dm.write_artefacts = write
        torch.cuda.synchronize()
        valid_s = time.perf_counter() - t0
        T = cfg.cond_frames + cfg.pred_frames
        want_files = {"metrics.txt", "sample0.gif", "origin.npy", "result.npy",
                      "origin_flows.npy", "result_flows.npy"}
        want_files |= {f"flow_vis/{k}_t{t:03d}.png" for k in ("flow", "conf") for t in range(T)}
        have = {str(p.relative_to(log_dir)) for p in log_dir.rglob("*") if p.is_file()}
        if have != want_files:
            raise AssertionError(f"valid_dm artefacts: missing {sorted(want_files - have)}, "
                                 f"extra {sorted(have - want_files)}")
        total_pred = vp["pred_frames"]
        shapes = {n: list(np.load(log_dir / n, mmap_mode="r").shape)
                  for n in ("origin.npy", "result.npy", "origin_flows.npy", "result_flows.npy")}
        h = cfg.frame_shape // 2
        want_shapes = {"origin.npy": [ARTEFACT_VIDEOS, tc + total_pred, cfg.frame_shape,
                                      cfg.frame_shape, 3]}
        want_shapes["result.npy"] = want_shapes["origin.npy"]
        want_shapes["origin_flows.npy"] = want_shapes["result_flows.npy"] = [
            ARTEFACT_VIDEOS, total_pred, h, h, 2]
        if shapes != want_shapes:
            raise AssertionError(f"artefact shapes {shapes} != {want_shapes}")
        want_gt = [dict(zero, grid_sample=GT_FLOW_WARPS)]  # one batch of every video
        if gt_calls != want_gt:
            raise AssertionError(f"GT-flow encode launches {gt_calls} != {want_gt}")
        want_call = dict(zero, **expected_launches(cfg))
        if sampler_calls != [want_call] * len(sampler_calls) or len(sampler_calls) != math.ceil(
                total_pred / cfg.pred_frames):
            raise AssertionError(f"valid_dm sampler call launches {sampler_calls}")
        with torch.no_grad():
            want = seen["lfae"].encode_video(seen["real"], tc)["flow"][:, tc:]
        got = torch.from_numpy(np.load(log_dir / "origin_flows.npy")[:1])
        res = check("origin_flows card vs cpu", got, want, UNET_F32_REL_TOL)
        log({"phase": "artefacts valid_dm", "config": "configs/DM/kth.yaml, float32 (valid_dm), "
             f"{ARTEFACT_VIDEOS} synthetic videos x {ARTEFACT_TRAJ} trajectories, random "
             "weights", "seconds": valid_s, "artefact_seconds": seen["seconds"],
             "gt_flow_launches": gt_calls, "sampler_calls": len(sampler_calls),
             "sampler_call_launches": want_call, "files": len(have), "shapes": shapes,
             "metrics_txt": (log_dir / "metrics.txt").read_text().splitlines(),
             "origin_flows_card_vs_cpu": res, "card": card})

        # ---- analyze_dumps on those dumps
        an_dir = Path(tmp) / "analysis"
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = analyze_dumps.main(["--dump_dir", str(log_dir), "--cond_frames", str(tc),
                                     "--out_dir", str(an_dir), "--per_video", "--render",
                                     "--device", "cuda"])
        torch.cuda.synchronize()
        an_s = time.perf_counter() - t0
        doc = json.load(open(an_dir / "metrics.json"))
        gifs = sorted(p.name for p in an_dir.rglob("*.gif"))
        if rc != 0 or sorted(doc) != ["fvd", "lpips", "psnr", "ssim"] or len(gifs) != \
                ARTEFACT_VIDEOS or not (an_dir / "metrics_per_video.csv").is_file():
            raise AssertionError(f"analyze_dumps: rc {rc}, metrics {sorted(doc)}, gifs {gifs}")
        log({"phase": "artefacts analyze_dumps", "seconds": an_s, "metrics": doc, "gifs": gifs,
             "card": card})

        # ---- video2video: kernel 4 in encode and decode, then its plain version
        v2v_dir = Path(tmp) / "v2v"
        v2v_calls, outs, call_s = [], {}, []
        transfer = video2video.transfer

        def timed_transfer(lfae, hybrid, tc_, device):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs["kernel"] = transfer(lfae, hybrid, tc_, device)
            call_s.append(time.perf_counter() - t0)
            with plain_sites(table["grid_sample"]):
                outs["plain"] = transfer(lfae, hybrid, tc_, device)
            return outs["kernel"]

        for c in counters.values():
            c.launches = 0
        video2video.transfer = timed_transfer
        t0 = time.perf_counter()
        try:
            with per_call_launches(video2video, "transfer", counters, v2v_calls):
                video2video.main(["--config", kth, "--synthetic_videos", "3", "--motion_indices",
                                  "1,2", "--dump_flow", "--log_dir", str(v2v_dir), "--device",
                                  "cuda"])
        finally:
            video2video.transfer = transfer
        v2v_s = time.perf_counter() - t0
        # the counted call holds the kernel call and the plain one (no launch)
        want_v2v = [dict(zero, grid_sample=TRANSFER_WARPS)]
        if v2v_calls != want_v2v:
            raise AssertionError(f"video2video launches {v2v_calls} != {want_v2v}")
        v2v_res = {k: check(f"video2video {k} kernel vs plain", torch.from_numpy(
            outs["kernel"][k]), torch.from_numpy(outs["plain"][k]), UNET_F32_REL_TOL)
            for k in ("out_vid", "flow")}
        files = sorted(str(p.relative_to(v2v_dir)) for p in v2v_dir.rglob("*") if p.is_file())
        want_v2v_files = 1 + 2 * 2 + 2 * 2 * 20  # gifs, then 20 frames' flow and grid pngs
        if len(files) != want_v2v_files:
            raise AssertionError(f"video2video files {files}")
        log({"phase": "artefacts video2video", "motion_videos": 2, "frames": 20,
             "ms_per_encode_call": call_s[0] * 1e3, "seconds": v2v_s, "launches": v2v_calls[0],
             "kernel_vs_plain": v2v_res, "files": len(files), "card": card})

        # ---- metrics.demo at the reference's 8 x 30 x 64^2
        shape = (8, 30, 64, 64, 3)
        v1, v2 = np.zeros(shape, np.float32), np.ones(shape, np.float32)
        out_json = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out_json), contextlib.redirect_stderr(io.StringIO()):
            rc = demo.main(["--device", "cuda"])
        demo_s = time.perf_counter() - t0
        doc = json.loads(out_json.getvalue())
        seconds = {}
        demo.demo_metrics(v1, v2, I3DExtractor(device="cuda"), LPIPSMetric(device="cuda"),
                          torch.device("cuda"), 8, seconds=seconds)
        tchw = lambda v: torch.from_numpy(v).permute(0, 1, 4, 2, 3)  # noqa: E731
        cpu = {"psnr": float(calculate_psnr1(tchw(v1), tchw(v2))[0]["psnr"]),
               "ssim": float(calculate_ssim1(tchw(v1), tchw(v2))[0]["ssim"])}
        errs = {k: abs(doc[k] - cpu[k]) for k in cpu}
        if rc != 0 or any(not e <= METRIC_F64_TOL for e in errs.values()) or not all(
                math.isfinite(doc[k]) for k in ("fvd", "psnr", "ssim", "lpips")):
            raise AssertionError(f"metrics.demo: rc {rc}, card {doc} vs cpu {cpu}")
        log({"phase": "artefacts metrics demo", "videos": list(shape), "seconds": demo_s,
             "metric_seconds": seconds, "psnr_ssim_card_vs_cpu_abs_err": errs,
             "keys": list(doc), "card": card})
    torch.cuda.empty_cache()
    log({"phase": "artefacts phase", "seconds": time.perf_counter() - t_phase, "card": card})
    return gt_calls[0], v2v_calls[0]


# ----------------------------------------------------------------- evaluation
def wm_table(table):
    """Kernel 9 in the layout of kernel_table. Its wrapper takes pre-windowed
    tokens; the layers are recorded at the UNet's call site (kernel 1's), so
    key, cost and residual are kernel 1's on the layer's input x. Its bf16
    body is kernel 1's (stw_layer.cu); the parent's body is attention.cu's
    (float32 and the shapes kernel 1's body refuses since)."""
    from extdm_tpu_torch.ops import fused_stw

    return {"stw_layer_wm": dict(
        wrapper=fused_stw.fused_stw_layer_wm, plain=fused_stw.stw_layer_wm_plain,
        sites=table["stw_layer"]["sites"], key=table["stw_layer"]["key"],
        cost=table["stw_layer"]["cost"], residual=None, parent=fused_stw._stw_wm_narrow,
        parent_source="extdm_tpu_torch/csrc/attention.cu",
        source="extdm_tpu_torch/csrc/stw_layer.cu", replaces="extdm_tpu/ops/pallas_stw.py:781")}


def wm_inputs(x, gamma, w_qkv, w_proj, b_proj, bias, *, window, shift, heads, dim_head,
              eps=1e-5, **_):
    """Kernel 9's operands for one STW layer, as the layer's route makes them."""
    from extdm_tpu_torch.ops import fused_stw

    xw, masks_exp, _ = fused_stw.wm_operands(x, window, shift)
    return ((xw, gamma, w_qkv, w_proj, b_proj, bias, masks_exp),
            dict(heads=heads, dim_head=dim_head, eps=eps))


# Kernel 9 (bf16) off the eval's layers: a 512-channel layer, a window of 32
# tokens (the volume clamps it; shifted, its masks expanded per window, 4
# heads), and 144 windows of 64 tokens, not a multiple of the persistent
# blocks (one per SM). (shape, shift asked, heads)
WM_EXTRA = (((2, 10, 8, 8, 512), (0, 0, 0), 8), ((2, 9, 4, 2, 192), (2, 2, 2), 4),
            ((3, 10, 16, 16, 96), (0, 0, 0), 8))


def wm_case(k9, kernel1, args, kwargs, what, card, count=None):
    """Kernel 9 on one layer (bf16): against its plain version, and the layer
    through kernel 9 (mode "1") against the layer through kernel 1 (mode
    "0"); times of the kernel and its plain version, the layer both ways,
    the device time of kernel 9, of kernel 1 on the same layer and of the
    parent's body (attention.cu, where it takes the layer: C <= 256). Logs
    a line; returns it."""
    x = args[0]
    wargs, wkw = wm_inputs(*args, **kwargs)
    layer = {m: dict(kwargs, window_major=m) for m in ("1", "0")}
    with torch.no_grad():
        res = check(f"stw_layer_wm {what}", k9["wrapper"](*wargs, **wkw),
                    k9["plain"](*wargs, **wkw), BF16_REL_TOL, wargs[0])
        res_k1 = check(f"stw_layer_wm {what} vs kernel 1", kernel1(*args, **layer["1"]),
                       kernel1(*args, **layer["0"]), BF16_REL_TOL, x)
        symbols = kernel_symbols(k9["source"])
        line = {"kernel": "stw_layer_wm", "shape": list(wargs[0].shape),
                "layer_shape": list(x.shape), "window": list(kwargs["window"]),
                "shift": list(kwargs["shift"]), "heads": kwargs["heads"],
                "dtype": str(x.dtype).replace("torch.", ""), "check": what,
                "kernel_ms": cuda_ms(lambda: k9["wrapper"](*wargs, **wkw), 10),
                "plain_ms": cuda_ms(lambda: k9["plain"](*wargs, **wkw), 10),
                "layer_ms_window_major": cuda_ms(lambda: kernel1(*args, **layer["1"]), 10),
                "layer_ms_kernel1": cuda_ms(lambda: kernel1(*args, **layer["0"]), 10),
                "kernel_device_ms": device_ms(lambda: k9["wrapper"](*wargs, **wkw), 10,
                                              symbols)[0],
                "kernel1_device_ms": device_ms(lambda: kernel1(*args, **layer["0"]), 10,
                                               symbols)[0],
                "parent_body_device_ms": parent_body_ms(k9, wargs, wkw, 10)}
    byts, flops, op_dtype = k9["cost"](*args, **kwargs)
    bytes_ms, ops_ms = byts / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[op_dtype] * 1e3
    line.update(bound_ms=max(bytes_ms, ops_ms), bytes_ms=bytes_ms, ops_ms=ops_ms, flops=flops,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                device_tflops=flops / line["kernel_device_ms"] / 1e9,
                bound_share=max(bytes_ms, ops_ms) / line["kernel_device_ms"], library_ms=None,
                library_ms_note="no single PyTorch call computes this layer", **res,
                vs_kernel1_max_abs_err=res_k1["max_abs_err"], card=card)
    if count is not None:
        line["per_call"] = count
    log(line)
    return line


def wm_kernel_phase(table, record, card):
    """Kernel 9 at every window-major layer the eval records (bf16) and at
    WM_EXTRA (``wm_case``); then a shifted layer of the eval in mode "1"
    with its expanded masks, and one float32 shape (attention.cu's body);
    returns the per-call totals of the recorded layers."""
    from extdm_tpu_torch.nn.attention import get_window_size
    from extdm_tpu_torch.ops import fused_stw

    k9, kernel1 = wm_table(table)["stw_layer_wm"], table["stw_layer"]["wrapper"]
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0, library_ms=None,
               max_abs_err=0.0, layer_ms=0.0, kernel1_layer_ms=0.0, device_ms=0.0, flops=0.0,
               kernel1_device_ms=0.0, parent_device_ms=0.0)
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
        line = wm_case(k9, kernel1, args, kwargs, "kernel 9 at an eval layer", card, count)
        for name, field in (("ms", "kernel_ms"), ("plain_ms", "plain_ms"),
                            ("layer_ms", "layer_ms_window_major"),
                            ("kernel1_layer_ms", "layer_ms_kernel1"), ("bound_ms", "bound_ms"),
                            ("bytes_ms", "bytes_ms"), ("ops_ms", "ops_ms"),
                            ("device_ms", "kernel_device_ms"), ("flops", "flops"),
                            ("kernel1_device_ms", "kernel1_device_ms"),
                            ("parent_device_ms", "parent_body_device_ms")):
            tot[name] += count * (line[field] or 0.0)
        tot["max_abs_err"] = max(tot["max_abs_err"], line["max_abs_err"])

    # the eval's shifted layer in mode "1": its masks expanded per window
    args, kwargs = shifted_case
    wm_case(k9, kernel1, args, kwargs, "kernel 9 at a shifted eval layer (mode 1, expanded masks)",
            card)
    g = torch.Generator(device="cuda").manual_seed(37)
    r = lambda *s, scale=1.0: torch.randn(s, generator=g, device="cuda") * scale  # noqa: E731
    dh = 32
    for shape, shift0, heads in WM_EXTRA:
        C = shape[-1]
        window, shift = get_window_size(shape[1:4], (4, 4, 4), shift0)
        N, hid = math.prod(window), heads * dh
        args = [r(*shape).bfloat16(), 1 + r(C, scale=0.1), r(3 * hid, C, scale=C ** -0.5),
                r(C, hid, scale=hid ** -0.5), r(C, scale=0.1), r(heads, N, N, scale=0.1)]
        kwargs = dict(window=window, shift=shift, heads=heads, dim_head=dh)
        wm_case(k9, kernel1, args, kwargs, f"kernel 9 off the eval's layers: {N} tokens, "
                f"{shape[0] * math.prod(-(-d // w) for d, w in zip(shape[1:4], window))} windows",
                card)

    torch.backends.cuda.matmul.allow_tf32 = False
    fargs, fkw = next((a, k) for n, a, k in f32_cases(torch.device("cuda")) if n == "stw_layer")
    for shift in ((2, 2, 2), (0, 0, 0)):
        wargs, wkw = wm_inputs(*fargs, **dict(fkw, shift=shift))
        res = check(f"stw_layer_wm float32 shift {shift}", k9["wrapper"](*wargs, **wkw),
                    k9["plain"](*wargs, **wkw), F32_REL_TOL)
        log({"kernel": "stw_layer_wm", "shape": list(wargs[0].shape), "dtype": "float32",
             "shift": list(shift), "check": "kernel vs plain (attention.cu's body)", **res})

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
    samples = out["samples"][:n].cuda()  # evaluate returns them in host memory
    real = out["real"][:2].repeat_interleave(EVAL_TRAJ, dim=0).cuda()
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
    got, want = i3d.get_feats(clips.cuda()), i3d_cpu.get_feats(clips)
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
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = evaluate(fd, loader, num_traj=EVAL_TRAJ, total_pred=total_pred, seed=1, i3d=i3d,
                   lpips=lpips)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    peak = {EVAL_TRAJ: torch.cuda.max_memory_allocated()}
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
    if samples.device.type != "cpu" or out["real"].device.type != "cpu":
        raise AssertionError("evaluate kept its samples on the card")
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
         "stw_layer_wm_device_ms_per_call": summary["device_ms"],
         "kernel1_same_layers_ms_per_call": summary["kernel1_layer_ms"],
         "kernel1_same_layers_device_ms_per_call": summary["kernel1_device_ms"],
         "stw_layer_wm_parent_body_device_ms_per_call": summary["parent_device_ms"],
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30, "card": card})
    check_metrics_card_vs_cpu(out, i3d, lpips)
    del out

    # twice the trajectories at the same sampler batch (half the videos per
    # loader batch): the samples stay in host memory, so the card's peak does
    # not grow with them
    torch.cuda.empty_cache()
    loader = DataLoader(dataset, EVAL_VIDEOS * EVAL_TRAJ // (2 * EVAL_TRAJ), shuffle=False,
                        num_workers=4, drop_last=False, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    out = evaluate(fd, loader, num_traj=2 * EVAL_TRAJ, total_pred=total_pred, seed=1, i3d=i3d,
                   lpips=lpips)
    torch.cuda.synchronize()
    peak[2 * EVAL_TRAJ] = torch.cuda.max_memory_allocated()
    host_gb = {k: out[k].numel() * out[k].element_size() / 2 ** 30 for k in ("real", "samples")}
    log({"check": "evaluate's peak device memory, num_traj 4 -> 8 at sampler batch 16",
         "peak_gb": {k: v / 2 ** 30 for k, v in peak.items()}, "host_gb": host_gb,
         "tol": EVAL_PEAK_REL_TOL})
    if peak[2 * EVAL_TRAJ] > (1 + EVAL_PEAK_REL_TOL) * peak[EVAL_TRAJ]:
        raise AssertionError(f"evaluate's peak device memory grew with the trajectories: {peak}")
    del fd, out, i3d, lpips
    torch.cuda.empty_cache()
    log({"phase": "eval phase", "seconds": time.perf_counter() - t_phase})
    return summary, launches, calls


# ----------------------------------------------------------------- multi1248
def route_table():
    """Kernels 10, 11 and 12 in the layout of kernel_table, with `library`:
    one PyTorch call that computes the same function (timed only)."""
    from extdm_tpu_torch.ops import fused_resnet, fused_stw, window_attn

    def conv_key(x, w, *a):
        return (tuple(x.shape), w.shape[-1])

    def conv_cost(x, w, b=None):
        B, T, H, W, Cin = x.shape
        P, Cout = B * T * H * W, w.shape[-1]
        byts = (x.numel() + w.numel()) * x.element_size() + P * Cout * 4
        return byts, 2 * P * 9 * Cin * Cout, x.dtype

    def conv_library(x, w, b=None):
        xn = x.permute(0, 4, 1, 2, 3).contiguous()
        wn = fused_resnet._conv_weight(w.to(x.dtype)).unsqueeze(2).contiguous()
        bn = None if b is None else b.to(x.dtype)
        return lambda: F.conv3d(xn, wn, bn, padding=(0, 1, 1))

    def bwd_key(da, a_in, w):
        return (tuple(a_in.shape), w.shape[-1])

    def bwd_cost(da, a_in, w):
        # da, a_in and w read once, din and dW (float32) written once; two
        # products of the forward's size (input and weight gradients)
        B, T, H, W, Cin = a_in.shape
        P, Cout = B * T * H * W, w.shape[-1]
        byts = (P * (Cin + Cout) + w.numel()) * a_in.element_size() + (P * Cin + w.numel()) * 4
        return byts, 2 * 2 * P * 9 * Cin * Cout, a_in.dtype

    def bwd_library(da, a_in, w):
        dan = da.to(a_in.dtype).permute(0, 4, 1, 2, 3).contiguous()
        an = a_in.permute(0, 4, 1, 2, 3).contiguous()
        wn = fused_resnet._conv_weight(w.to(a_in.dtype)).unsqueeze(2).contiguous()
        return lambda: torch.ops.aten.convolution_backward(
            dan, an, wn, None, [1, 1, 1], [0, 1, 1], [1, 1, 1], False, [0, 0, 0], 1,
            [True, True, False])

    def attn_key(q, k, v, bias, mask=None):
        return (tuple(q.shape), mask is not None)

    def attn_cost(q, k, v, bias, mask=None):
        # q, k, v read and o written once, the bias and the mask tables
        byts = 4 * q.numel() * q.element_size() + bias.numel() * 4
        if mask is not None:
            byts += mask[0].numel() * 4 + mask[1].numel() * 4
        BW, H, N, D = q.shape
        return byts, 4 * BW * H * N * N * D, q.dtype

    def attn_library(q, k, v, bias, mask=None):
        add = bias.float()[None].expand(q.shape[0], -1, -1, -1)
        if mask is not None:
            masks, ids = mask
            seq = ids.long()[torch.arange(q.shape[0], device=q.device) % ids.numel()]
            add = add + masks[seq][:, None]
        add = add.to(q.dtype).contiguous()
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=add, scale=1.0)

    return {
        "conv33_fwd": dict(
            wrapper=fused_resnet.conv33_fwd, plain=fused_resnet.conv33_plain,
            sites=[(fused_resnet, "conv33_fwd")], key=conv_key, cost=conv_cost,
            library=conv_library, library_call="F.conv3d (NCDHW-contiguous operands)",
            source="extdm_tpu_torch/csrc/conv33.cu",
            replaces="extdm_tpu/ops/pallas_resnet.py:773"),
        "conv33_bwd": dict(
            wrapper=fused_resnet.conv33_bwd, plain=fused_resnet.conv33_bwd_plain,
            sites=[(fused_resnet, "conv33_bwd")], key=bwd_key, cost=bwd_cost,
            library=bwd_library,
            library_call="aten.convolution_backward (input and weight, NCDHW-contiguous)",
            source="extdm_tpu_torch/csrc/conv33.cu",
            replaces="extdm_tpu/ops/pallas_resnet.py:803"),
        "window_attention": dict(
            wrapper=window_attn.fused_window_attention, plain=window_attn.window_attention_plain,
            sites=[(fused_stw, "fused_window_attention")], key=attn_key, cost=attn_cost,
            library=attn_library,
            library_call="F.scaled_dot_product_attention, float mask = bias + shift mask",
            source="extdm_tpu_torch/csrc/window_attn.cu",
            replaces="extdm_tpu/ops/pallas_attn.py:137"),
    }


def wide_layers(cfg, limit=256):
    """Layers of the UNet over the narrow kernels' channel limit, by the
    UNet's widths (unet3d.py: per level 2 resnet blocks, 2 window layers
    and a temporal layer at the level's width; the mid blocks at the
    deepest width): the window layers (kernels 1 and 5 in bf16), the
    temporal layers (kernels 2 and 6 in bf16; both unfused around kernel 12
    in float32) and the resnet blocks whose backward is decomposed (Cout
    over the limit)."""
    dims = [cfg.dim] + [cfg.dim * m for m in cfg.dim_mults]
    widths = dims[1:] + dims[-2::-1][:len(dims) - 1]  # downs at d_out, ups at d_in
    n = {"stw": 2 * sum(w > limit for w in widths) + 2 * (dims[-1] > limit),
         "temporal": sum(w > limit for w in widths),
         "resnet": 2 * sum(w > limit for w in widths) + 2 * (dims[-1] > limit)}
    return n


def expected_route_launches(cfg):
    """Launches per sampler call and per train step (remat, bf16) of every
    kernel, with the wide layers on their routes: the wide window and
    temporal layers on kernels 1 and 2 and, in training, 5 and 6 (their bf16
    bodies take 512 channels), so no layer runs unfused and kernel 12 not
    at all; every resnet backward on kernel 7 (its bf16 body takes any
    width), so kernels 10 and 11 not at all."""
    call = dict(expected_launches(cfg), window_attention=0, conv33_fwd=0, conv33_bwd=0)
    fwd, bwd = expected_train_launches(cfg)
    step = {**fwd, **bwd}
    step.update(window_attention=0, conv33_fwd=0, conv33_bwd=0)
    return call, step


def narrow_only(name, record):
    """Kernels 1, 2, 5 and 6 never see a layer over their bodies' 512
    channels: every recorded input of `name` has at most 512 channels."""
    for key in record:
        if key[0][-1] > 512:
            raise AssertionError(f"{name} launched on a layer of {key[0][-1]} > 512 channels")


def route_kernel_checks(rt, record, card, per):
    """Kernels 10-12 against their plain versions at every recorded shape,
    in bf16 and in float32 (the same inputs cast), and CUDA-event times of
    the wrapper call (host work included), plain version and library call,
    and the kernel's own device time (``device_ms``), beside the wrapper's
    device time read by ``queued_ms`` (its kernels and other ops: the
    reading ``device_ms`` falls back to); returns per-call (or per-step)
    totals by kernel. TF32 off: the float32 plain versions in full
    float32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    summary = {}
    for name, k in rt.items():
        tot = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, plain_device_ms=0.0, library_ms=0.0,
                   library_device_ms=0.0, bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
                   max_abs_err=0.0)
        if name not in record:
            continue
        for key, entry in record[name].items():
            args, kwargs, count = entry["args"], entry["kwargs"], entry["count"]
            res = {}
            for dtype in (torch.bfloat16, torch.float32):
                cast = [a.to(dtype) if torch.is_tensor(a) and a.dtype in (torch.bfloat16,
                                                                           torch.float32)
                        and a.ndim >= 3 else a for a in args]
                got, want = k["wrapper"](*cast, **kwargs), k["plain"](*cast, **kwargs)
                torch.cuda.synchronize()
                if name == "conv33_bwd":  # din and dW, with the backward kernels' limits
                    lim = ((BWD_MAX_REL_TOL, BWD_MEAN_REL_TOL) if dtype == torch.bfloat16
                           else (F32_REL_TOL, F32_REL_TOL))
                    r = check_grads(f"{name}{key} {dtype}", got, want, *lim)
                else:
                    r = check(f"{name}{key} {dtype}", got, want,
                              BF16_REL_TOL if dtype == torch.bfloat16 else F32_REL_TOL)
                res[str(dtype).replace("torch.", "")] = r
            ms = cuda_ms(lambda: k["wrapper"](*args, **kwargs), 10)
            dev_ms, dev_other_ms = device_ms(lambda: k["wrapper"](*args, **kwargs), 10,
                                             kernel_symbols(k["source"]))
            queued = queued_ms(lambda: k["wrapper"](*args, **kwargs), 10)
            plain_ms = cuda_ms(lambda: k["plain"](*args, **kwargs), 10)
            plain_dev_ms = device_ms(lambda: k["plain"](*args, **kwargs), 10)[0]
            library_ms = cuda_ms(k["library"](*args, **kwargs), 10)
            library_dev_ms = device_ms(k["library"](*args, **kwargs), 10)[0]
            byts, flops, op_dtype = k["cost"](*args, **kwargs)
            bytes_ms, ops_ms = byts / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[op_dtype] * 1e3
            dt = args[1 if name == "conv33_bwd" else 0].dtype
            log({"kernel": name, "shape": list(key[0]), "key": str(key[1:]),
                 "dtype": str(dt).replace("torch.", ""), per: count, "kernel_ms": ms,
                 "kernel_device_ms": dev_ms, "wrapper_other_device_ms": dev_other_ms,
                 "wrapper_queued_ms": queued,
                 "plain_ms": plain_ms, "plain_device_ms": plain_dev_ms, "library_ms": library_ms,
                 "library_device_ms": library_dev_ms, "library_call": k["library_call"],
                 "bound_ms": max(bytes_ms, ops_ms),
                 "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                 "device_tflops": flops / dev_ms / 1e9,
                 "bound_share": max(bytes_ms, ops_ms) / dev_ms,
                 "call_minus_device_us": (ms - dev_ms) * 1e3, "checks": res, "card": card})
            for field, value in (("ms", ms), ("device_ms", dev_ms), ("plain_ms", plain_ms),
                                 ("plain_device_ms", plain_dev_ms), ("library_ms", library_ms),
                                 ("library_device_ms", library_dev_ms),
                                 ("bound_ms", max(bytes_ms, ops_ms)), ("bytes_ms", bytes_ms),
                                 ("ops_ms", ops_ms)):
                tot[field] += count * value
            tot["max_abs_err"] = max(tot["max_abs_err"], res["bfloat16"]["max_abs_err"],
                                     res["float32"]["max_abs_err"])
        summary[name] = tot
    return summary


def wide_checks(k, name, keys, entries, card, per, what, backward=False):
    """Kernel `name` (1, 2, 5 or 6) against its plain version at the
    multi1248 layers over 256 channels (`keys` of its recorded `entries`),
    kernel 6 also twice for bitwise equal gradients; timed (the wrapper call
    and its device time); returns the totals per call (or step)."""
    tot = dict(ms=0.0, device_ms=0.0, bound_ms=0.0, flops=0.0)
    for key in keys:
        args, kwargs, count = entries[key]["args"], entries[key]["kwargs"], entries[key]["count"]
        with torch.set_grad_enabled(False):
            if backward:
                got = k["wrapper"](*args, **kwargs)
                res = check_grads(f"{name}{key} multi1248", got, k["plain"](*args, **kwargs),
                                  BWD_MAX_REL_TOL, BWD_MEAN_REL_TOL)
                if name in REPEATS:
                    repeat_check(name, key, got, k["wrapper"](*args, **kwargs))
            else:
                res = check(f"{name}{key} multi1248", k["wrapper"](*args, **kwargs),
                            k["plain"](*args, **kwargs), BF16_REL_TOL,
                            k["residual"](*args, **kwargs))
            reps = 5 if backward else 10
            ms = cuda_ms(lambda: k["wrapper"](*args, **kwargs), reps)
            dev_ms = device_ms(lambda: k["wrapper"](*args, **kwargs), reps,
                               kernel_symbols(k["source"]))[0]
        byts, flops, op_dtype = k["cost"](*args, **kwargs)
        bound = max(byts / HBM_BYTES_PER_S, flops / PEAK_FLOPS[op_dtype]) * 1e3
        log({"kernel": name, "shape": list(key[0]), "key": str(key[1:]), per: count,
             "kernel_ms": ms, "kernel_device_ms": dev_ms, "bound_ms": bound,
             "device_tflops": flops / dev_ms / 1e9, "bound_share": bound / dev_ms,
             "check": what, **res, "card": card})
        for field, value in (("ms", ms), ("device_ms", dev_ms), ("bound_ms", bound),
                             ("flops", flops)):
            tot[field] += count * value
    return tot


def kernel12_record(rt, entries, keys):
    """Kernel 12's inputs where it ran before kernels 2 and 6 took the
    512-channel temporal layer: ``temporal_layer_unfused`` (that layer's
    former route) called on the layer's recorded inputs, in the layout of
    recording(), each with its layer's count."""
    from extdm_tpu_torch.ops import fused_stw

    record = {}
    with recording({"window_attention": rt["window_attention"]}, record), torch.no_grad():
        for key in keys:
            before = set(record["window_attention"])
            fused_stw.temporal_layer_unfused(*entries[key]["args"], **entries[key]["kwargs"])
            for k12 in set(record["window_attention"]) - before:
                record["window_attention"][k12]["count"] = entries[key]["count"]
    return record


def unfused_table():
    """The unfused window and temporal layers at their call sites in the
    UNet, in the layout of kernel_table (recorded and timed only; kernel
    12 inside them is counted as window_attention). In bf16 no multi1248
    layer takes them; the wide temporal layers are timed on them as the
    route kernels 2 and 6 replaced."""
    from extdm_tpu_torch.models.dm import unet3d
    from extdm_tpu_torch.ops import fused_stw

    def key(x, *a, **k):
        return (tuple(x.shape),)

    return {name: dict(wrapper=getattr(fused_stw, name), plain=getattr(fused_stw, plain),
                       key=key, sites=[(unet3d, name)])
            for name, plain in (("stw_layer_unfused", "stw_layer_plain"),
                                ("temporal_layer_unfused", "temporal_layer_plain"))}


def unfused_split(utable, record, train: bool) -> dict:
    """The unfused layers' time, summed over the recorded calls: the whole
    layer (CUDA events), the plain layer (torch attention in place of
    kernel 12), and the layer's device time split into kernel 12 and the
    torch ops around it (``device_ms``). `train`: each layer's forward and
    backward together (the step calls each layer once, under autograd)."""
    symbols = kernel_symbols("extdm_tpu_torch/csrc/window_attn.cu")
    tot = dict(layer_ms=0.0, plain_layer_ms=0.0, kernel12_device_ms=0.0, torch_device_ms=0.0,
               calls=0)
    for name, k in utable.items():
        for key, entry in record[name].items():
            args = [a.detach() if torch.is_tensor(a) else a for a in entry["args"]]
            count = entry["count"]
            if train:
                args = [a.requires_grad_(True) if torch.is_tensor(a) and a.is_floating_point()
                        else a for a in args]
                g = torch.randn_like(args[0])

                def run(fn, args=args, g=g, kwargs=entry["kwargs"]):
                    fn(*args, **kwargs).backward(g)
            else:
                def run(fn, args=args, kwargs=entry["kwargs"]):
                    with torch.no_grad():
                        fn(*args, **kwargs)
            layer_ms = cuda_ms(lambda: run(k["wrapper"]), 5)
            plain_ms = cuda_ms(lambda: run(k["plain"]), 5)
            own, other = device_ms(lambda: run(k["wrapper"]), 5, symbols)
            log({"layer": name, "shape": list(key[0]), "train": train,
                 ("per_step" if train else "per_call"): count, "layer_ms": layer_ms,
                 "plain_layer_ms": plain_ms, "kernel12_device_ms": own, "torch_device_ms": other})
            for field, value in (("layer_ms", layer_ms), ("plain_layer_ms", plain_ms),
                                 ("kernel12_device_ms", own), ("torch_device_ms", other),
                                 ("calls", 1)):
                tot[field] += count * value
    return tot


def multi1248_phase(table, btable, others, card):
    """The multi1248/ada preset at full KTH width (see the module docstring, 9)."""
    from extdm_tpu_torch.config import kth_multi1248_config
    from extdm_tpu_torch.models.dm import unet3d
    from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusion
    from extdm_tpu_torch.ops import fused_resnet
    from extdm_tpu_torch.train.dm_trainer import DMTrainer, make_optimizer

    t_phase = time.perf_counter()
    rt = route_table()
    cfg = kth_multi1248_config(dtype=torch.bfloat16)
    want_call, want_step = expected_route_launches(cfg)
    wide = wide_layers(cfg)
    counters = {n: k["wrapper"] for n, k in {**table, **btable, **others, **rt}.items()}

    routes = {"unfused": 0, "decomposed": 0}
    stw_route, bwd_route = unet3d.stw_route, fused_resnet.resnet_bwd_route

    def counted(fn):
        def route(*a, **k):
            r = fn(*a, **k)
            routes[r] = routes.get(r, 0) + 1
            return r
        return route

    @contextlib.contextmanager
    def counting_routes():
        unet3d.stw_route, fused_resnet.resnet_bwd_route = counted(stw_route), counted(bwd_route)
        try:
            yield
        finally:
            unet3d.stw_route, fused_resnet.resnet_bwd_route = stw_route, bwd_route

    def run_counted(fn):
        for c in counters.values():
            c.launches = 0
        routes.update(unfused=0, decomposed=0)
        t0 = time.perf_counter()
        with counting_routes():
            out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, {n: c.launches for n, c in counters.items()}

    # ---- sampling: recorded warm-up, then 3 timed calls
    fd = FlowDiffusion(cfg, device="cuda", seed=0)
    sampler = fd.make_sampler()
    cond = torch.rand((BATCH, cfg.cond_frames, cfg.frame_shape, cfg.frame_shape, 3),
                      generator=torch.Generator().manual_seed(6)).cuda()
    gen = torch.Generator(device="cuda")
    record, urecord = {}, {}
    utable = unfused_table()
    with recording({**table, **rt}, record), recording(utable, urecord):
        sampler(gen.manual_seed(0), cond)
        torch.cuda.synchronize()
    for name in ("stw_layer", "temporal_layer"):  # kernels 1 and 2 take 512 channels
        narrow_only(name, record[name])
    wide_stw = [k for k in record["stw_layer"] if k[0][-1] > 256]
    wide_tmp = [k for k in record["temporal_layer"] if k[0][-1] > 256]
    if not wide_stw or not wide_tmp or record["window_attention"] or any(urecord.values()):
        raise AssertionError(f"multi1248 sampler: layers over 256 channels on kernel 1 {wide_stw} "
                             f"and kernel 2 {wide_tmp}; kernel 12 calls "
                             f"{list(record.get('window_attention', {}))}, unfused layers "
                             f"{ {n: list(r) for n, r in urecord.items()} }")
    # kernel 12 and the unfused layer at the 512-channel temporal layer's
    # inputs: the route it took before kernels 2 and 6 took it
    record.update(kernel12_record(rt, record["temporal_layer"], wide_tmp))
    urecord["temporal_layer_unfused"] = {k: record["temporal_layer"][k] for k in wide_tmp}
    wide_keys = [k for k in record["resnet_block"] if k[1] > 256]
    log({"phase": "multi1248 warm-up call", "window_attention_shapes": [str(k) for k in
                                                                        record["window_attention"]],
         "resnet_forward_shapes_over_256": [str(k) for k in wide_keys], "wide_layers": wide})
    with torch.no_grad():
        summary = route_kernel_checks(rt, record, card, "per_call")
    # kernels 1 and 2 at the 512-channel layers they take in sampling
    k1_wide = wide_checks(table["stw_layer"], "stw_layer", wide_stw, record["stw_layer"], card,
                          "per_call", "kernel 1 vs plain at a multi1248 512-channel window layer")
    k2_wide = wide_checks(table["temporal_layer"], "temporal_layer", wide_tmp,
                          record["temporal_layer"], card, "per_call",
                          "kernel 2 vs plain at the multi1248 512-channel temporal layer")
    # kernel 3 at every block of the multi1248 sampler (512 output channels
    # and up level 0's 1024 input channels among them)
    k3, k3_wide_ms, k3_ms, k3_dev_ms = table["resnet_block"], 0.0, 0.0, 0.0
    for key, entry in record["resnet_block"].items():
        args, kwargs = entry["args"], entry["kwargs"]
        with torch.no_grad():
            res = check(f"resnet_block{key}", k3["wrapper"](*args, **kwargs),
                        k3["plain"](*args, **kwargs), BF16_REL_TOL,
                        k3["residual"](*args, **kwargs))
            ms = cuda_ms(lambda: k3["wrapper"](*args, **kwargs), 5)
            dev_ms = device_ms(lambda: k3["wrapper"](*args, **kwargs), 5,
                               kernel_symbols(k3["source"]))[0]
        byts, flops, op_dtype = k3["cost"](*args, **kwargs)
        bound = max(byts / HBM_BYTES_PER_S, flops / PEAK_FLOPS[op_dtype]) * 1e3
        k3_wide_ms += entry["count"] * ms if key[1] > 256 else 0.0
        k3_ms += entry["count"] * ms
        k3_dev_ms += entry["count"] * dev_ms
        log({"kernel": "resnet_block", "shape": list(key[0]), "cout": key[1],
             "per_call": entry["count"], "kernel_ms": ms, "kernel_device_ms": dev_ms,
             "bound_ms": bound, "device_tflops": flops / dev_ms / 1e9,
             "bound_share": bound / dev_ms,
             "check": "kernel 3 vs plain at a multi1248 shape", **res, "card": card})
    usplit = unfused_split(utable, urecord, train=False)
    del record, urecord
    times = []
    for i in range(TIMED_CALLS):
        out, sec, launches = run_counted(lambda: sampler(gen.manual_seed(200 + i), cond))
        times.append(sec)
        expected = {n: want_call.get(n, 0) for n in counters}
        if launches != expected or routes["unfused"] != 0:
            raise AssertionError(f"multi1248 call {i}: launches {launches} != {expected}, or "
                                 f"routes {routes}")
        if not torch.isfinite(out["sample_out_vid"]).all():
            raise AssertionError(f"multi1248 call {i}: non-finite samples")
    call_launches = launches
    med = statistics.median(times)
    log({"phase": "multi1248 sampling", "config": "KTH 64px tc=10 tp=20 DDIM-10 bf16, "
         "multi1248/ada (dim_mults 1,2,4,8)", "batch": BATCH, "ms_per_call": [t * 1e3 for t in
                                                                              times],
         "median_ms": med * 1e3, "predicted_frames_per_s": BATCH * cfg.pred_frames / med,
         "launches_per_call": launches, "unfused_layers_per_call": routes["unfused"],
         "kernel2_c512_ms_per_call": k2_wide["ms"],
         "kernel2_c512_device_ms_per_call": k2_wide["device_ms"],
         "former_route_same_layers": "temporal_layer_unfused (kernel 12) on kernel 2's "
                                     "512-channel inputs, timed only",
         "window_attention_ms_per_call": summary["window_attention"]["ms"],
         "window_attention_device_ms_per_call": summary["window_attention"]["device_ms"],
         "unfused_layers_ms_per_call": usplit["layer_ms"],
         "unfused_plain_layers_ms_per_call": usplit["plain_layer_ms"],
         "unfused_kernel12_device_ms_per_call": usplit["kernel12_device_ms"],
         "unfused_torch_device_ms_per_call": usplit["torch_device_ms"],
         "kernel1_c512_ms_per_call": k1_wide["ms"],
         "kernel1_c512_device_ms_per_call": k1_wide["device_ms"],
         "kernel3_cout512_ms_per_call": k3_wide_ms, "kernel3_ms_per_call": k3_ms,
         "kernel3_device_ms_per_call": k3_dev_ms, "card": card})
    # float32: the layers over 256 channels take kernel 12 (the narrow bodies'
    # limit), counted from 0 over this forward: kernel 12's launches
    for c in counters.values():
        c.launches = 0
    unet_f32_card_vs_cpu(cfg)
    f32_launches = {n: c.launches for n, c in counters.items()}
    if f32_launches["window_attention"] != wide["stw"] + wide["temporal"]:
        raise AssertionError(f"multi1248 float32 forward: kernel 12 launched "
                             f"{f32_launches['window_attention']} times, not once per layer over "
                             f"256 channels ({wide['stw'] + wide['temporal']})")
    log({"check": "multi1248 float32 UNet forward at batch 1: every layer over 256 channels "
                  "unfused around kernel 12", "launches": f32_launches, "card": card})
    del fd, sampler, out
    torch.cuda.empty_cache()

    # ---- training: recorded warm-up step, kernel checks, 3 timed steps
    tcfg = kth_multi1248_config(dtype=torch.bfloat16, remat=True)
    fd = FlowDiffusion(tcfg, device="cuda", seed=0)
    trainer = DMTrainer(fd, make_optimizer(fd.unet.parameters(), 2e-4, (500000,), 0.5))
    T, px = tcfg.cond_frames + tcfg.pred_frames, tcfg.frame_shape
    video = torch.rand((TRAIN_BATCH, T, px, px, 3),
                       generator=torch.Generator().manual_seed(7)).cuda()
    record, urecord = {}, {}
    with recording({**table, **btable, **rt}, record), recording(utable, urecord):
        trainer.train_step(gen.manual_seed(0), video)
        torch.cuda.synchronize()
    for name in ("stw_layer", "stw_layer_bwd", "temporal_layer", "temporal_layer_bwd"):
        narrow_only(name, record[name])  # kernels 1, 2, 5 and 6 take 512 channels
    wide_k7 = {k: e for k, e in record["resnet_block_bwd"].items() if k[1] > 256}
    if sum(e["count"] for e in wide_k7.values()) != wide["resnet"]:
        raise AssertionError(f"multi1248 train step: kernel 7 on {list(wide_k7)}, not on the "
                             f"{wide['resnet']} blocks over 256 channels")
    if record["window_attention"] or any(urecord.values()):
        raise AssertionError(f"multi1248 train step: kernel 12 calls "
                             f"{list(record.get('window_attention', {}))}, unfused layers "
                             f"{ {n: list(r) for n, r in urecord.items()} }")
    # kernels 5 and 6 at the 512-channel layers they take under autograd
    wide_bwd = {n: [k for k in record[n] if k[0][-1] > 256]
                for n in ("stw_layer_bwd", "temporal_layer_bwd")}
    if not all(wide_bwd.values()):
        raise AssertionError(f"multi1248 train step: layers over 256 channels on kernels 5 and "
                             f"6: {wide_bwd}")
    k5_wide = wide_checks(btable["stw_layer_bwd"], "stw_layer_bwd", wide_bwd["stw_layer_bwd"],
                          record["stw_layer_bwd"], card, "per_step",
                          "kernel 5 vs plain backward at a multi1248 512-channel window layer",
                          backward=True)
    k6_wide = wide_checks(btable["temporal_layer_bwd"], "temporal_layer_bwd",
                          wide_bwd["temporal_layer_bwd"], record["temporal_layer_bwd"], card,
                          "per_step", "kernel 6 vs plain backward at the multi1248 512-channel "
                          "temporal layer, bitwise equal on repeat", backward=True)
    # kernel 12 and the unfused layer (forward and backward) at the
    # 512-channel temporal layer's training inputs: its former route
    wide_tmp = [k for k in record["temporal_layer"] if k[0][-1] > 256]
    record.update(kernel12_record(rt, record["temporal_layer"], wide_tmp))
    urecord["temporal_layer_unfused"] = {k: record["temporal_layer"][k] for k in wide_tmp}
    # kernel 7 at every block of the step, in bf16 at batch 8: the 512-channel
    # blocks, up level 0 (Cin 1024) and the other shapes the KTH step does not
    # have; twice, bitwise
    k7, k7_wide = btable["resnet_block_bwd"], dict(ms=0.0, device_ms=0.0)
    for key, entry in record["resnet_block_bwd"].items():
        args, kwargs = entry["args"], entry["kwargs"]
        got = k7["wrapper"](*args, **kwargs)
        repeat_check("resnet_block_bwd multi1248", key, got, k7["wrapper"](*args, **kwargs))
        res = check_grads(f"resnet_block_bwd{key} multi1248", got, k7["plain"](*args, **kwargs),
                          BWD_MAX_REL_TOL, BWD_MEAN_REL_TOL)
        ms = cuda_ms(lambda: k7["wrapper"](*args, **kwargs), 5)
        dev_ms = device_ms(lambda: k7["wrapper"](*args, **kwargs), 5,
                           kernel_symbols(k7["source"]))[0]
        byts, flops, op_dtype = k7["cost"](*args, **kwargs)
        bound = max(byts / HBM_BYTES_PER_S, flops / PEAK_FLOPS[op_dtype]) * 1e3
        if key[1] > 256:
            k7_wide["ms"] += entry["count"] * ms
            k7_wide["device_ms"] += entry["count"] * dev_ms
        log({"kernel": "resnet_block_bwd", "shape": list(key[0]), "key": str(key[1:]),
             "per_step": entry["count"], "kernel_ms": ms, "kernel_device_ms": dev_ms,
             "bound_ms": bound, "device_tflops": flops / dev_ms / 1e9,
             "bound_share": bound / dev_ms,
             "check": "kernel 7 vs plain backward at a multi1248 shape, bitwise equal on repeat",
             **res, "card": card})
    # the decomposed route (kernels 10 and 11) at the blocks over 256 channels,
    # which it ran before kernel 7 took them: the A/B, and kernels 10 and 11
    # checked and timed at its conv shapes
    csummary = resnet_bwd_ab(wide_k7, card, "multi1248 train step (batch 8, bf16), the blocks "
                                            "over 256 channels")
    with torch.no_grad():
        tsummary = route_kernel_checks({"window_attention": rt["window_attention"]}, record, card,
                                       "per_step")
        tsummary.update(csummary)
        ragged = conv_ragged_record()
        route_kernel_checks({n: rt[n] for n in ragged}, ragged, card, "ragged")
        conv_bwd_repeat_check(ragged["conv33_bwd"], card)
        del ragged
    tsplit = unfused_split(utable, urecord, train=True)
    del record, urecord
    times = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(TIMED_STEPS):
        aux, sec, launches = run_counted(lambda: trainer.train_step(gen.manual_seed(10 + i), video))
        times.append(sec)
        expected = {n: want_step.get(n, 0) for n in counters}
        loss, grad_norm = aux["loss"].item(), aux["grad_norm"].item()
        if not (math.isfinite(loss) and math.isfinite(grad_norm)):
            raise AssertionError(f"multi1248 train step {i}: loss {loss}, grad_norm {grad_norm}")
        if launches != expected or (routes["unfused"], routes["decomposed"]) != (0, 0):
            raise AssertionError(f"multi1248 train step {i}: launches {launches} != {expected}, "
                                 f"or routes {routes}")
        log({"phase": "multi1248 train step", "step": i, "ms": sec * 1e3, "loss": loss,
             "grad_norm": grad_norm})
    step_launches = launches
    med = statistics.median(times)
    log({"phase": "multi1248 train end to end", "config": "KTH 64px tc=10 tp=20, multi1248/ada, "
         "bf16 compute, float32 master weights, remat", "batch": TRAIN_BATCH,
         "ms_per_step": [t * 1e3 for t in times], "median_ms": med * 1e3,
         "train_frames_per_s": TRAIN_BATCH * T / med, "launches_per_step": launches,
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
         "kernel7_cout512_ms_per_step": k7_wide["ms"],
         "kernel7_cout512_device_ms_per_step": k7_wide["device_ms"],
         "former_route_cout512": "decomposed (kernels 10-11), timed only: the ab lines",
         "former_route_same_layers": "temporal_layer_unfused (kernel 12) forward and backward "
                                     "on kernel 2's 512-channel inputs, timed only",
         "unfused_layers_fwd_bwd_ms_per_step": tsplit["layer_ms"],
         "unfused_plain_layers_fwd_bwd_ms_per_step": tsplit["plain_layer_ms"],
         "unfused_kernel12_device_ms_per_step": tsplit["kernel12_device_ms"],
         "unfused_torch_device_ms_per_step": tsplit["torch_device_ms"],
         "kernel5_c512_ms_per_step": k5_wide["ms"],
         "kernel5_c512_device_ms_per_step": k5_wide["device_ms"],
         "kernel6_c512_ms_per_step": k6_wide["ms"],
         "kernel6_c512_device_ms_per_step": k6_wide["device_ms"], "card": card})
    log({"check": "multi1248 train step routes: every window and temporal layer fused "
                  "(kernels 1, 2, 5 and 6), none unfused, kernel 12 never",
         "unfused_layers_per_step": routes["unfused"],
         "kernel12_launches_per_step": launches["window_attention"],
         "kernel1_launches_per_step": launches["stw_layer"],
         "kernel2_launches_per_step": launches["temporal_layer"],
         "kernel5_launches_per_step": launches["stw_layer_bwd"],
         "kernel6_launches_per_step": launches["temporal_layer_bwd"],
         "decomposed_resnet_backwards_per_step": routes["decomposed"], "card": card})
    del trainer, fd, video
    torch.cuda.empty_cache()
    # float32: the blocks over 256 channels take the decomposed route (kernel
    # 7's float32 body keeps 256), counted from 0 over this step: kernels 10
    # and 11's launches
    for c in counters.values():
        c.launches = 0
    with counting_routes():
        routes.update(unfused=0, decomposed=0)
        train_f32_card_vs_cpu(tcfg)
    f32_step = {n: c.launches for n, c in counters.items()}
    if (f32_step["conv33_fwd"], f32_step["conv33_bwd"], routes["decomposed"]) != (
            2 * wide["resnet"], 2 * wide["resnet"], wide["resnet"]):
        raise AssertionError(f"multi1248 float32 step: kernels 10 / 11 launched "
                             f"{f32_step['conv33_fwd']} / {f32_step['conv33_bwd']} times and "
                             f"{routes['decomposed']} blocks decomposed, not twice / once per "
                             f"block over 256 channels ({wide['resnet']})")
    log({"check": "multi1248 float32 train step at batch 1: every resnet backward over 256 "
                  "channels decomposed (kernels 10 and 11)", "launches": f32_step, "card": card})
    log({"phase": "multi1248 phase", "seconds": time.perf_counter() - t_phase})
    # kernel 12 per sampler call had the wide temporal layer stayed unfused,
    # kernels 10 and 11 per train step at the decomposed route's shapes
    return ({**tsummary, "window_attention": summary["window_attention"]}, call_launches,
            step_launches, f32_launches, f32_step)


# Kernels 10 and 11 at shapes off the model's: channels off the kernels'
# 16-byte rows (padded), frames smaller than a tile, and pixels not a
# multiple of the row tile.
CONV_RAGGED = (((2, 3, 5, 7, 12), 20), ((1, 8, 4, 4, 40), 72), ((3, 7, 6, 5, 64), 96))


def conv_ragged_record(seed=11):
    """Seeded inputs of kernels 10 and 11 at CONV_RAGGED, in the layout of
    recording(): bf16 activations; float32 weights, bias and output
    gradient, which the wrappers cast."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s, scale=1.0: torch.randn(s, generator=g, device="cuda") * scale  # noqa: E731
    record = {"conv33_fwd": {}, "conv33_bwd": {}}
    for shape, cout in CONV_RAGGED:
        x = r(*shape).to(torch.bfloat16)
        w = r(9, shape[-1], cout, scale=(9 * shape[-1]) ** -0.5)
        key = (tuple(shape), cout)
        record["conv33_fwd"][key] = {"args": [x, w, r(cout, scale=0.1)], "kwargs": {}, "count": 1}
        record["conv33_bwd"][key] = {"args": [r(*shape[:-1], cout), x, w], "kwargs": {},
                                     "count": 1}
    return record


def conv_bwd_repeat_check(entries, card):
    """Kernel 11 twice on the same inputs at each recorded shape: din and dW
    the same bit for bit (per-split partials added in order, no atomics)."""
    from extdm_tpu_torch.ops import fused_resnet

    for key, entry in entries.items():
        repeat_check("conv33_bwd", key, fused_resnet.conv33_bwd(*entry["args"]),
                     fused_resnet.conv33_bwd(*entry["args"]))
        log({"check": "kernel 11 twice on the same inputs: bitwise equal din and dW",
             "shape": list(key[0]), "cout": key[1], "card": card})


def resnet_bwd_ab(entries, card, what="KTH train step (batch 8, bf16)"):
    """Kernel 7 against the decomposed backward (kernels 10-11 and the torch
    GroupNorm math) at the recorded resnet-backward `entries` of a step: ms
    per step of each, summed over the shapes' counts. Timed and printed.
    First, kernels 10 and 11 at every conv shape of those decomposed
    backwards (each block's decomposed backward run as often as the step
    runs the block): checked against their plain versions (bf16 and
    float32), timed, and kernel 11 checked to repeat bit for bit; returns
    their per-step totals (``route_kernel_checks``)."""
    from extdm_tpu_torch.ops import fused_resnet

    rt = {n: k for n, k in route_table().items() if n.startswith("conv33")}
    conv_record = {}
    with recording(rt, conv_record), torch.no_grad():
        for entry in entries.values():
            for _ in range(entry["count"]):
                fused_resnet.resnet_block_bwd_decomposed(*entry["args"], **entry["kwargs"])
        summary = route_kernel_checks(rt, conv_record, card, "per_ab_block")
        conv_bwd_repeat_check(conv_record["conv33_bwd"], card)
    del conv_record
    fused_ms = decomposed_ms = 0.0
    for key, entry in entries.items():
        args, kwargs, count = entry["args"], entry["kwargs"], entry["count"]
        f = cuda_ms(lambda: fused_resnet.resnet_block_bwd(*args, **kwargs), 5)
        d = cuda_ms(lambda: fused_resnet.resnet_block_bwd_decomposed(*args, **kwargs), 5)
        fd = device_ms(lambda: fused_resnet.resnet_block_bwd(*args, **kwargs), 5,
                       kernel_symbols("extdm_tpu_torch/csrc/resnet.cu"))[0]
        dd = device_ms(lambda: fused_resnet.resnet_block_bwd_decomposed(*args, **kwargs), 5)[0]
        fused_ms += count * f
        decomposed_ms += count * d
        log({"ab": "resnet backward", "step": what, "shape": list(key[0]), "cout": key[1],
             "per_step": count, "kernel7_ms": f, "decomposed_ms": d, "kernel7_device_ms": fd,
             "decomposed_device_ms": dd, "card": card})
    log({"ab": f"resnet backward per {what}", "shapes": len(entries),
         "kernel7_ms_per_step": fused_ms, "decomposed_ms_per_step": decomposed_ms, "card": card})
    return summary


def resnet_backward_step_ab(trainer, video, counters, want, card):
    """The whole-step A/B of the resnet backward routes: `trainer`'s KTH step
    with ``resnet_bwd_route`` as it is (kernel 7 on every block) against the
    same step with the gate sending every block "decomposed" (kernels 10-11
    and the torch GroupNorm math), in turns, launches checked on both.
    Printed only."""
    from extdm_tpu_torch.ops import fused_resnet

    route = fused_resnet.resnet_bwd_route
    blocks = want["resnet_block_bwd"]
    wants = {"fused": want, "decomposed": dict(want, resnet_block_bwd=0, conv33_fwd=2 * blocks,
                                               conv33_bwd=2 * blocks)}
    gen = torch.Generator(device="cuda")
    times = {"fused": [], "decomposed": []}
    try:
        for i in range(TIMED_STEPS + 1):  # the first pair warms up the decomposed route
            for mode in ("fused", "decomposed"):
                fused_resnet.resnet_bwd_route = (route if mode == "fused"
                                                 else lambda *a: "decomposed")
                for fn in counters.values():
                    fn.launches = 0
                t0 = time.perf_counter()
                aux = trainer.train_step(gen.manual_seed(30 + i), video)
                torch.cuda.synchronize()
                if i:
                    times[mode].append((time.perf_counter() - t0) * 1e3)
                launches = {n: fn.launches for n, fn in counters.items()}
                if launches != wants[mode] or not math.isfinite(aux["loss"].item()):
                    raise AssertionError(f"resnet backward {mode} step {i}: launches {launches} "
                                         f"!= {wants[mode]}, or loss {aux['loss'].item()}")
    finally:
        fused_resnet.resnet_bwd_route = route
    log({"ab": "resnet backward routes per KTH train step (batch 8, bf16)",
         "fused_ms": times["fused"], "decomposed_ms": times["decomposed"],
         "fused_median_ms": statistics.median(times["fused"]),
         "decomposed_median_ms": statistics.median(times["decomposed"]), "card": card})


# ------------------------------------ w_ref/traj, AE bf16 and the sampler variants
def check_sample(out, cfg, B, decode=True):
    """The sampler's keys, shapes and finite values."""
    T, px = cfg.cond_frames + cfg.pred_frames, cfg.frame_shape
    want = {"sample_vid_grid": (B, T, px // 2, px // 2, 2),
            "sample_vid_conf": (B, T, px // 2, px // 2, 1),
            "real_vid_grid": (B, cfg.cond_frames, px // 2, px // 2, 2),
            "real_vid_conf": (B, cfg.cond_frames, px // 2, px // 2, 1)}
    if decode:
        want.update(sample_out_vid=(B, T, px, px, 3), sample_warped_vid=(B, T, px, px, 3))
    if set(out) != set(want):
        raise AssertionError(f"sampler keys {sorted(out)} != {sorted(want)}")
    for key, shape in want.items():
        if tuple(out[key].shape) != shape or not torch.isfinite(out[key]).all():
            raise AssertionError(f"{key}: shape {tuple(out[key].shape)} (want {shape}) or "
                                 f"non-finite")


# make_sampler(decode=False) and sample_video against make_sampler() on the
# card, same generator seed. They run the same computation and draws (bit
# for bit on the CPU: tests/test_torch_variants.py), and the encode's
# latents (real_vid_*) agree bit for bit here too. The sampled latents and
# pixels do not repeat bit for bit on the card: kernel 3 sums its GroupNorm
# statistics with float atomics, whose order varies between calls (kernels 7
# and 8 sum in a fixed order; kernel 3 keeps its design in this slice), and
# ten bf16 DDIM steps with noise carry those last-bit differences into
# visible ones (a second make_sampler() call on the same seed moved a decoded
# pixel by 0.138). So each sampled output of a variant is held by its mean
# difference from make_sampler()'s: at most SPREAD_MULT times the mean
# difference of a second make_sampler() call on the same seed, plus one bf16
# ulp (2^-8) of the output's mean magnitude. A variant that sampled other
# draws, decoded other frames or dropped a step differs by about the
# output's own size.
SPREAD_MULT = 4.0


def sampler_variants_phase(fd, cond, card):
    """make_sampler(decode=False) against the decoding sampler's latents,
    and sample_video against make_sampler(), each on the same generator
    seed: the keys and shapes, real_vid_* bit for bit, the sampled outputs
    within SPREAD_MULT of make_sampler()'s spread against itself."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    calls = {}
    for name, fn in (("make_sampler()", lambda: fd.make_sampler()(gen.manual_seed(7), cond)),
                     ("make_sampler() again", lambda: fd.make_sampler()(gen.manual_seed(7), cond)),
                     ("make_sampler(decode=False)",
                      lambda: fd.make_sampler(decode=False)(gen.manual_seed(7), cond)),
                     ("sample_video", lambda: fd.sample_video(gen.manual_seed(7), cond))):
        t1 = time.perf_counter()
        calls[name] = fn()
        torch.cuda.synchronize()
        check_sample(calls[name], fd.cfg, cond.shape[0], name != "make_sampler(decode=False)")
        calls[name]["ms"] = (time.perf_counter() - t1) * 1e3
    full, again = calls["make_sampler()"], calls["make_sampler() again"]
    spread = {k: (again[k].float() - full[k].float()).abs().mean().item()
              for k in full if k != "ms"}
    lines = []
    for name in ("make_sampler(decode=False)", "sample_video"):
        out, line = calls[name], {"variant": name, "ms": calls[name]["ms"]}
        for key in [k for k in out if k != "ms"]:
            diff = (out[key].float() - full[key].float()).abs()
            if key.startswith("real_"):
                if not torch.equal(out[key], full[key]):
                    raise AssertionError(f"{name}: {key} differs from make_sampler()'s")
                continue
            tol = SPREAD_MULT * spread[key] + 2.0 ** -8 * full[key].float().abs().mean().item()
            line[key] = {"mean_abs_err": diff.mean().item(), "max_abs_err": diff.max().item(),
                         "tol": tol, "repeat_mean_abs_err": spread[key],
                         "bitwise": bool(torch.equal(out[key], full[key]))}
            if not diff.mean().item() <= tol:
                raise AssertionError(f"{name} {key}: mean difference from make_sampler()'s "
                                     f"{line[key]}")
        lines.append(line)
    log({"phase": "sampler variants", "batch": cond.shape[0], "variants": lines,
         "repeat_mean_abs_err": spread, "seconds": time.perf_counter() - t0, "card": card})


def n32_record_phase(table, record, name, card, what):
    """Kernel 1 (forward, `name` "stw_layer") or kernel 5 ("stw_layer_bwd")
    against its plain version at every recorded window layer of N = 32
    tokens, bf16; CUDA-event and device time, bound. Returns the per-call or
    per-step totals."""
    k = table[name]
    tot = dict(ms=0.0, plain_ms=0.0, device_ms=0.0, bound_ms=0.0, flops=0.0, max_abs_err=0.0,
               launches=0, shapes=0)
    symbols = kernel_symbols(k["source"])
    backward = name.endswith("_bwd")
    for key, entry in record[name].items():
        args, kwargs, count = entry["args"], entry["kwargs"], entry["count"]
        if math.prod(kwargs["window"]) != 32:
            raise AssertionError(f"{name}{key}: window {kwargs['window']}, not 32 tokens")
        got = k["wrapper"](*args, **kwargs)
        want = k["plain"](*args, **kwargs)
        torch.cuda.synchronize()
        if backward:
            res = check_grads(f"{name}{key} N=32", got, want, BWD_MAX_REL_TOL, BWD_MEAN_REL_TOL)
        else:
            res = check(f"{name}{key} N=32", got, want, BF16_REL_TOL,
                        k["residual"](*args, **kwargs))
        reps = 5
        ms = cuda_ms(lambda: k["wrapper"](*args, **kwargs), reps)
        plain_ms = cuda_ms(lambda: k["plain"](*args, **kwargs), reps)
        dev_ms = device_ms(lambda: k["wrapper"](*args, **kwargs), reps, symbols)[0]
        byts, flops, op_dtype = k["cost"](*args, **kwargs)
        bytes_ms, ops_ms = byts / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[op_dtype] * 1e3
        bound = max(bytes_ms, ops_ms)
        log({"kernel": name, "config": what, "shape": list(key[0]), "key": str(key[1:]),
             "tokens": 32, "dtype": "bfloat16", "per_call": count, "kernel_ms": ms,
             "kernel_device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound,
             "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
             "device_tflops": flops / dev_ms / 1e9, "bound_share": bound / dev_ms, **res,
             "card": card})
        for field, value in (("ms", ms), ("plain_ms", plain_ms), ("device_ms", dev_ms),
                             ("bound_ms", bound), ("flops", flops)):
            tot[field] += count * value
        tot["launches"] += count
        tot["shapes"] += 1
        tot["max_abs_err"] = max(tot["max_abs_err"], res["max_abs_err"])
    return tot


def traj_sampling_phase(table, others, card):
    """The w_ref/traj KTH preset (window (2, 4, 4): N = 32, shift (1, 2, 2)
    over T = 30; TrajWarp at every DDIM step, no cond cache) in bf16 at
    batch 4: a recorded warm-up call, kernel 1 at each of its N = 32 layer
    shapes, 3 timed calls with every launch count, and the float32 traj
    UNet at batch 1, card vs CPU."""
    from extdm_tpu_torch.config import kth_traj_config
    from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusion

    t_phase = time.perf_counter()
    cfg = kth_traj_config()
    fd = FlowDiffusion(cfg, device="cuda", seed=0)
    sampler = fd.make_sampler()
    cond = torch.rand((BATCH, cfg.cond_frames, cfg.frame_shape, cfg.frame_shape, 3),
                      generator=torch.Generator().manual_seed(1)).cuda()
    gen = torch.Generator(device="cuda")
    record = {}
    t0 = time.perf_counter()
    with recording(table, record):
        sampler(gen.manual_seed(1), cond)
        torch.cuda.synchronize()
    want = expected_launches(cfg)
    seen = {n: sum(e["count"] for e in r.values()) for n, r in record.items()}
    log({"phase": "traj warm-up request", "seconds": time.perf_counter() - t0,
         "shapes": {n: len(r) for n, r in record.items()}, "launches": seen})
    if seen != want:
        raise AssertionError(f"traj warm-up kernel calls {seen} != expected {want}")
    n32 = n32_record_phase(table, record, "stw_layer", card, "w_ref/traj sampler, batch 4")
    del record

    counters = {n: k["wrapper"] for n, k in {**table, **others}.items()}
    want = {n: want.get(n, 0) for n in counters}
    times = []
    for i in range(TIMED_CALLS):
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        out = sampler(gen.manual_seed(100 + i), cond)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches = {n: fn.launches for n, fn in counters.items()}
        if launches != want:
            raise AssertionError(f"traj request {i}: kernel launches {launches} != {want}")
    check_sample(out, cfg, BATCH)
    med = statistics.median(times)
    log({"phase": "traj sampling", "config": "KTH 64px tc=10 tp=20 DDIM-10 bf16, w_ref/traj "
         "(window (2,4,4), TrajWarp, adaptors from level 2)", "batch": BATCH,
         "ms_per_call": [t * 1e3 for t in times], "median_ms": med * 1e3,
         "predicted_frames_per_s": BATCH * cfg.pred_frames / med,
         "launches_per_call": {n: c for n, c in launches.items() if c},
         "kernel1_n32": n32, "card": card})
    del fd, sampler
    torch.cuda.empty_cache()
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    unet_f32_card_vs_cpu(cfg, "w_ref/traj unet3d")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    log({"phase": "traj sampling phase", "seconds": time.perf_counter() - t_phase})
    return n32, launches


def traj_train_phase(table, btable, others, card):
    """The w_ref/traj preset's DM train step at batch 8 (remat, bf16
    compute, float32 master weights): a recorded warm-up step, kernel 5 at
    each of its N = 32 layer shapes against the plain backward, 3 timed
    steps with every launch count."""
    from extdm_tpu_torch.config import kth_traj_config
    from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusion
    from extdm_tpu_torch.train.dm_trainer import DMTrainer, make_optimizer

    t_phase = time.perf_counter()
    cfg = kth_traj_config(remat=True)
    fd = FlowDiffusion(cfg, device="cuda", seed=0)
    trainer = DMTrainer(fd, make_optimizer(fd.unet.parameters(), 2e-4, (500000,), 0.5))
    T, px = cfg.cond_frames + cfg.pred_frames, cfg.frame_shape
    video = torch.rand((TRAIN_BATCH, T, px, px, 3),
                       generator=torch.Generator().manual_seed(2)).cuda()
    gen = torch.Generator(device="cuda")
    record = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with recording(btable, record):
        aux = trainer.train_step(gen.manual_seed(0), video)
        torch.cuda.synchronize()
    want_fwd, want_bwd = expected_train_launches(cfg)
    seen = {n: sum(e["count"] for e in r.values()) for n, r in record.items()}
    log({"phase": "traj train warm-up step", "seconds": time.perf_counter() - t0,
         "loss": aux["loss"].item(), "grad_norm": aux["grad_norm"].item(), "launches": seen})
    if seen != want_bwd:
        raise AssertionError(f"traj warm-up backward kernel calls {seen} != {want_bwd}")
    n32 = n32_record_phase(btable, record, "stw_layer_bwd", card, "w_ref/traj step, batch 8")
    del record

    counters = {n: k["wrapper"] for n, k in {**table, **btable, **others}.items()}
    want = {n: {**want_fwd, **want_bwd}.get(n, 0) for n in counters}
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
            raise AssertionError(f"traj train step {i}: loss {loss}, grad_norm {grad_norm}")
        if launches != want:
            raise AssertionError(f"traj train step {i}: launches {launches} != {want}")
    med = statistics.median(times)
    log({"phase": "traj train", "config": "KTH 64px tc=10 tp=20 w_ref/traj, bf16 compute, "
         "float32 master weights, remat", "batch": TRAIN_BATCH,
         "ms_per_step": [t * 1e3 for t in times], "median_ms": med * 1e3,
         "train_frames_per_s": TRAIN_BATCH * T / med,
         "launches_per_step": {n: c for n, c in launches.items() if c},
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30, "kernel5_n32": n32,
         "card": card})
    del trainer, fd
    torch.cuda.empty_cache()
    log({"phase": "traj train phase", "seconds": time.perf_counter() - t_phase})
    return n32, launches


# bf16 AE step vs the float32 step on the same batch, weights, augmentation
# and TPS draw: each loss within this fraction of the float32 one. The
# policy rounds every conv's inputs and outputs to bf16 (2^-8 relative) and
# the losses pass through train-mode BatchNorm and the temperature-0.1 region
# softmax, which amplify that rounding: at full width on the CPU (batch 4,
# the seeded init) the bf16 losses lay up to 2.1% from the float32 ones
# (equivariance_shift), and the JAX package's bf16 losses up to 1.45% from
# its float32 ones at the tiny test model. 5% leaves more than twice the
# first; a lost or doubled term moves a loss by far more.
AE_BF16_LOSS_REL_TOL = 0.05


def ae_bf16_phase(table, ae_btable, others, card, f32_ms):
    """The AE step at batch 64 with the bf16 compute policy
    (ReconstructionModel(dtype=bfloat16)): a recorded warm-up step; kernels
    4 and 8 at its shapes (bf16 images: the K+1 source warps and the
    decode's; float32: the TPS warp) against their plain versions; the
    losses against the float32 step's on the same batch, weights and draws;
    parameters, gradients and BatchNorm statistics float32 after a step; 3
    timed steps with launch counts beside the float32 step's median."""
    from extdm_tpu_torch.config import kth_ae_training_config
    from extdm_tpu_torch.models.lfae.transform import random_tps
    from extdm_tpu_torch.train.device_augment import sample_augment
    from extdm_tpu_torch.train.train_ae import frozen_statistics

    t_phase = time.perf_counter()
    job_defaults()
    cfg = kth_ae_training_config()
    trainer = ae_model_and_trainer(cfg, "cuda", dtype=torch.bfloat16)
    px = cfg["frame_shape"]
    g = torch.Generator().manual_seed(3)
    batch = {k: torch.randint(0, 256, (AE_BATCH, px, px), generator=g, dtype=torch.uint8).cuda()
             for k in ("source", "driving")}
    gen = torch.Generator(device="cuda")
    warp = {"grid_sample": table["grid_sample"]}
    frecord, record = {}, {}
    t0 = time.perf_counter()
    with recording(warp, frecord), recording(ae_btable, record):
        aux = trainer.train_step(gen.manual_seed(0), batch)
        torch.cuda.synchronize()
    want = {"grid_sample": 6, "grid_sample_bwd": 5}
    seen = {n: sum(e["count"] for e in r.values()) for n, r in {**frecord, **record}.items()}
    log({"phase": "AE bf16 warm-up step", "seconds": time.perf_counter() - t0,
         "losses": {k: v.float().item() for k, v in aux.items()}, "launches": seen})
    if seen != want:
        raise AssertionError(f"AE bf16 warm-up warp calls {seen} != expected {want}")
    summary = {}
    for name, rec, k in (("grid_sample", frecord, warp["grid_sample"]),
                         ("grid_sample_bwd", record, ae_btable["grid_sample_bwd"])):
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, max_abs_err=0.0,
                   launches=0, bf16=0)
        for key, entry in rec[name].items():
            args, kwargs, count = entry["args"], entry["kwargs"], entry["count"]
            image = args[1] if name == "grid_sample_bwd" else args[0]
            bf16 = image.dtype == torch.bfloat16
            got, want_k = k["wrapper"](*args, **kwargs), k["plain"](*args, **kwargs)
            torch.cuda.synchronize()
            if name == "grid_sample_bwd":
                res = (check_grads(f"{name}{key}", got, want_k, BWD_MAX_REL_TOL, BWD_MEAN_REL_TOL)
                       if bf16 else check_grads(f"{name}{key}", got, want_k, F32_REL_TOL,
                                                F32_REL_TOL))
            else:
                res = check(f"{name}{key}", got, want_k, BF16_REL_TOL if bf16 else F32_REL_TOL)
            ms = cuda_ms(lambda: k["wrapper"](*args, **kwargs), 5)
            plain_ms = cuda_ms(lambda: k["plain"](*args, **kwargs), 5)
            if name == "grid_sample_bwd":  # ATen takes one dtype for all three operands
                g, img, grid = args[:3]
                library = warp_bwd_library(g.to(img.dtype), img, grid.to(img.dtype), *args[3:],
                                           **kwargs)
            else:
                img_nchw, grid = args[0].permute(0, 3, 1, 2), args[1].to(args[0].dtype)
                library = lambda: F.grid_sample(  # noqa: E731
                    img_nchw, grid, mode="bilinear", align_corners=True,
                    padding_mode=kwargs.get("padding_mode", "zeros"))
            library_ms = cuda_ms(library, 5)
            byts, flops, op_dtype = k["cost"](*args, **kwargs)
            bound = max(byts / HBM_BYTES_PER_S, flops / PEAK_FLOPS[op_dtype]) * 1e3
            log({"kernel": name, "config": "AE step bf16 policy, batch 64",
                 "shape": list(key[0]) if isinstance(key[0], tuple) else str(key),
                 "key": str(key[1:]), "dtype": str(image.dtype).replace("torch.", ""),
                 "per_step": count, "kernel_ms": ms, "plain_ms": plain_ms,
                 "library_ms": library_ms, "bound_ms": bound, **res, "card": card})
            tot["ms"] += count * ms
            tot["plain_ms"] += count * plain_ms
            tot["library_ms"] += count * library_ms
            tot["bound_ms"] += count * bound
            tot["launches"] += count
            tot["bf16"] += count * bf16
            tot["max_abs_err"] = max(tot["max_abs_err"], res["max_abs_err"])
        summary[name] = tot
    if not (summary["grid_sample"]["bf16"] and summary["grid_sample_bwd"]["bf16"]):
        raise AssertionError(f"AE bf16 step: no bf16 warp ran: {summary}")
    del frecord, record

    # the losses against the float32 step's: same weights (same seed), batch and draws
    draws = torch.Generator().manual_seed(5)
    augment = sample_augment(draws, AE_BATCH, (px, px), **cfg["device_augment"])
    tps = random_tps(draws, AE_BATCH, **cfg["model"]["transform_params"])
    trainer32 = ae_model_and_trainer(cfg, "cuda")
    trainer16 = ae_model_and_trainer(cfg, "cuda", dtype=torch.bfloat16)
    losses = {}
    for run, tr in (("float32", trainer32), ("bf16", trainer16)):
        with torch.no_grad(), frozen_statistics(tr.model):
            total, ls = tr.loss(None, batch, tps=tps, augment=augment)
        losses[run] = {k: v.float().item() for k, v in ls.items()} | {"total": total.item()}
    del trainer32, trainer16
    rel = {k: abs(losses["bf16"][k] - v) / abs(v) for k, v in losses["float32"].items()}
    if not all(math.isfinite(v) for v in losses["bf16"].values()) or any(
            r > AE_BF16_LOSS_REL_TOL for r in rel.values()):
        raise AssertionError(f"AE bf16 losses {losses['bf16']} vs float32 {losses['float32']}: "
                             f"relative {rel} (limit {AE_BF16_LOSS_REL_TOL})")
    model = trainer.model
    kinds = {"parameters": {p.dtype for p in model.parameters()},
             "gradients": {p.grad.dtype for p in model.parameters() if p.grad is not None},
             "batchnorm statistics": {b.dtype for n, b in model.named_buffers()
                                      if "running" in n}}
    if any(v != {torch.float32} for v in kinds.values()):
        raise AssertionError(f"AE bf16 step: {kinds} (all must be float32)")
    log({"check": "AE step bf16 policy vs float32, batch 64, same weights, batch and draws",
         "losses_bf16": losses["bf16"], "losses_float32": losses["float32"], "rel_err": rel,
         "tol": AE_BF16_LOSS_REL_TOL, "dtypes_after_step": {k: [str(d) for d in v]
                                                             for k, v in kinds.items()}})

    counters = {n: k["wrapper"] for n, k in {**table, **ae_btable, **others}.items()}
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
        if not all(torch.isfinite(v).all() for v in aux.values()):
            raise AssertionError(f"AE bf16 step {i}: losses {aux}")
        if launches != expected:
            raise AssertionError(f"AE bf16 step {i}: launches {launches} != {expected}")
    med = statistics.median(times)
    log({"phase": "AE bf16", "config": "configs/AE/kth.yaml, bf16 compute policy (float32 "
         "parameters and BatchNorm statistics)", "batch": AE_BATCH,
         "ms_per_step": [t * 1e3 for t in times], "median_ms": med * 1e3,
         "pairs_per_s": AE_BATCH / med, "float32_median_ms": f32_ms,
         "float32_pairs_per_s": AE_BATCH / f32_ms * 1e3,
         "launches_per_step": {n: c for n, c in launches.items() if c},
         "warps": summary, "card": card})
    del trainer, batch
    torch.cuda.empty_cache()
    ae_bf16_job_run(counters, card, med * 1e3)
    log({"phase": "AE bf16 phase", "seconds": time.perf_counter() - t_phase})
    return summary, launches


def ae_bf16_job_run(counters, card, bare_step_ms):
    """train/train_ae.py main with --bf16 (and --device_augment) for 2 steps
    on the card: configs/AE/kth.yaml at batch 64 of 8 in-memory videos.
    Checks the launches of each step, finite losses, float32 parameters and
    statistics in the trainer after the run and the checkpoint's float32
    tensors."""
    import tempfile

    from extdm_tpu_torch.train import checkpoint, train_ae
    from extdm_tpu_torch.train.ae_trainer import AETrainer

    job_defaults()
    want_step = {n: {"grid_sample": 6, "grid_sample_bwd": 5}.get(n, 0) for n in counters}
    trainers = []
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = job_yaml("configs/AE/kth.yaml", tmp, "flow_params", print_freq=1,
                            update_ckpt_freq=2, save_img_freq=2, num_repeats=8,
                            dataloader_workers=8)
        log_dir = str(Path(tmp) / "bf16")
        steps = []
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        with per_call_launches(AETrainer, "train_step", counters, steps,
                               lambda args: trainers.append(args[0])):
            train_ae.main(["--config", cfg_path, "--batch_size", "64", "--synthetic_videos", "8",
                           "--valid_every", "0", "--device", "cuda", "--bf16",
                           "--device_augment", "--max_steps", "2", "--log_dir", log_dir])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        recs = check_job_run(log_dir, "loss_total", range(2),
                             ["train.log", "metrics.jsonl", train_ae.CKPT], "")
        if len(steps) != 2 or any(s != want_step for s in steps):
            raise AssertionError(f"AE bf16 job: step launches {steps} != {want_step}")
        model = trainers[0].model
        if model.dtype != torch.bfloat16 or {p.dtype for p in model.parameters()} != {
                torch.float32}:
            raise AssertionError("AE bf16 job: the model is not the bf16 policy on float32 "
                                 "parameters")
        saved = checkpoint.load_checkpoint(str(Path(log_dir) / train_ae.CKPT))
        kinds = {v.dtype for part in checkpoint.AE_PARTS for v in saved[part].values()
                 if v.is_floating_point()}
        if kinds != {torch.float32}:
            raise AssertionError(f"AE bf16 job: checkpoint tensors {kinds}")
    del trainers
    torch.cuda.empty_cache()
    log({"phase": "AE job", "config": "configs/AE/kth.yaml, --bf16 --device_augment, batch 64, "
         "8 in-memory videos x 8 repeats", "launches_per_step": {n: c for n, c in
                                                                 want_step.items() if c},
         **job_timing(recs, bare_step_ms), "seconds": seconds, "steps": len(steps),
         "card": card})


# ------------------------------------------------------------ data parallel
# Phase "DP": the data-parallel DM step, AE step (SyncBN) and sharded
# sampler at full KTH width in DP_RANKS spawned ranks. On one card the
# ranks share it over gloo (nccl serves one rank per card): a smoke of the
# collectives and of every rank's kernel route at its local batch, not a
# scaling figure; gloo stages every all-reduce through host memory. Each
# step's result is held against the single-process step on the same global
# batch and draws, here in the parent process: the mean absolute difference
# of the parameters (gradients, losses, statistics) at most SPREAD_MULT
# times a spread plus 2^-8 of the mean update (or of the mean magnitude).
# The DM's spread is a second single-process step from the same state
# (kernel 3's GroupNorm atomics do not repeat bit for bit). The AE's
# single-process step repeats to ~1e-8, so its spread is a step on the
# augmented frames moved by AE_ROUGH_EPS: its gradients are rough at init
# (AE_ROUGH_MULT), and the ranks' reduction orders differ (SyncBN's
# E[x^2] - E[x]^2, cuDNN at 32 pairs). The AE comparison step runs with
# TF32 off on both sides: in TF32, cuDNN's algorithms at 32 and 64 pairs
# round differently enough to flip the sign of Adam's first update on many
# parameters (an H100 at 700 W), far beyond either spread; its timed steps
# run with TF32 on. With two cards or more the ranks also run over nccl,
# one a card.
DP_RANKS = 2
DP_DM_BATCH = 8
DP_AE_BATCH = 64
DP_SAMPLER_BATCH = 4
DP_TIMED_STEPS = 2


def _flat_params(module) -> torch.Tensor:
    return torch.cat([p.detach().float().reshape(-1) for p in module.parameters()])


def _flat_grads(module) -> torch.Tensor:
    """Every parameter's gradient, flat, on the host."""
    return torch.cat([p.grad.detach().float().reshape(-1) for p in module.parameters()]).cpu()


@contextlib.contextmanager
def tf32_off():
    """cuDNN and cuBLAS in full float32 for the block, PyTorch's defaults
    after (job_defaults)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        job_defaults()


def _stats(module) -> torch.Tensor:
    """Every BatchNorm running mean and variance, flat, on the host."""
    return torch.cat([b.detach().float().reshape(-1) for n, b in module.named_buffers()
                      if n.endswith(("running_mean", "running_var"))]).cpu()


def _spread_check(got, first, again, base):
    """got and again against first by their mean absolute difference:
    the line, "ok" where got's is at most SPREAD_MULT times again's plus
    2^-8 of mean|first - base| (one bf16 ulp of the step's mean update; of
    mean|first| without a base)."""
    err = (got - first).abs().mean().item()
    spread = (again - first).abs().mean().item()
    moved = (first - base).abs().mean().item() if base is not None else first.abs().mean().item()
    tol = SPREAD_MULT * spread + 2.0 ** -8 * moved
    return {"ok": err <= tol, "mean_abs_err": err, "max_abs_err": (got - first).abs().max().item(),
            "spread_mean_abs_err": spread, "mean_update": moved, "tol": tol}


def _digest(module) -> list:
    """A checksum of every parameter and buffer of `module`, on its device:
    per tensor, the sum of its float32 bit patterns (as int64) weighted by
    their positions, so that equal states give equal lists."""
    return [_digest_tensor(t) for t in module.state_dict().values()]


def _digest_tensor(t) -> int:
    bits = t.detach().float().reshape(-1).view(torch.int32).long()
    return int((bits * torch.arange(1, bits.numel() + 1, device=bits.device)).sum())


def dp_reference(tmp):
    """The single-process DM step on the global batch twice from the same
    state (the seeded init), the AE step on its global batch and on its
    frames moved by AE_ROUGH_EPS; writes the ranks' inputs (the batches
    and draws, the init's checksums) to <tmp>/dp_inputs.pt and returns the
    references (on the host)."""
    from extdm_tpu_torch.config import kth_ae_training_config, kth_training_config
    from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusion
    from extdm_tpu_torch.models.lfae.transform import random_tps
    from extdm_tpu_torch.parallel import resident_bytes
    from extdm_tpu_torch.train.device_augment import prepare_batch, sample_augment
    from extdm_tpu_torch.train.dm_trainer import DMTrainer, make_optimizer

    cfg = kth_training_config(torch.bfloat16)
    fd = FlowDiffusion(cfg, device="cuda", seed=0)
    T, px, tc = cfg.cond_frames + cfg.pred_frames, cfg.frame_shape, cfg.cond_frames
    g = torch.Generator().manual_seed(61)
    video = torch.rand((DP_DM_BATCH, T, px, px, 3), generator=g)
    with torch.no_grad():
        latent = fd.latents_from_encode(fd.lfae.encode_video(video[:1].cuda(), tc))
    t = torch.randint(0, cfg.timesteps, (DP_DM_BATCH,), generator=g)
    noise = torch.randn((DP_DM_BATCH, cfg.pred_frames, *latent.shape[2:]), generator=g)
    init = {k: v.detach().clone() for k, v in fd.unet.state_dict().items()}
    dm = {"init": _flat_params(fd.unet).cpu(), "params": [], "grads": [], "loss": [],
          "resident_bytes": []}
    dm_inputs = {"unet_digest": _digest(fd.unet), "lfae_digest": _digest(fd.lfae),
                 "video": video, "t": t, "noise": noise}
    for _ in range(2):
        fd.unet.load_state_dict(init)
        trainer = DMTrainer(fd, make_optimizer(fd.unet.parameters(), 2e-4, (500000,), 0.5))
        aux = trainer.train_step(None, video.cuda(), t=t.cuda(), noise=noise.cuda())
        torch.cuda.synchronize()
        dm["params"].append(_flat_params(fd.unet).cpu())
        dm["grads"].append(_flat_grads(fd.unet))
        dm["loss"].append(aux["loss"].item())
        dm["resident_bytes"].append(resident_bytes(trainer.optimizer))
    del fd, trainer, init
    torch.cuda.empty_cache()

    acfg = kth_ae_training_config()
    apx = acfg["frame_shape"]
    g = torch.Generator().manual_seed(62)
    batch = {k: torch.randint(0, 256, (DP_AE_BATCH, apx, apx), generator=g, dtype=torch.uint8)
             for k in ("source", "driving")}
    gen = torch.Generator(device="cuda").manual_seed(63)
    augment = sample_augment(gen, DP_AE_BATCH, (apx, apx), torch.device("cuda"),
                             **acfg["device_augment"])
    # The AE's single-process step repeats to within ~1e-8 (kernel 8's
    # vector reductions), but its gradients are rough at its init
    # (AE_ROUGH_MULT): a second step on the augmented frames moved by
    # AE_ROUGH_EPS gives the scale of float32 noise that the ranks' other
    # reduction orders (SyncBN's E[x^2] - E[x]^2, cuDNN at 32 pairs) meet.
    trainer = ae_model_and_trainer(acfg, "cuda")
    tps = random_tps(torch.Generator(device="cuda").manual_seed(64), DP_AE_BATCH,
                     device="cuda", **trainer.model.transform_params)
    ae = {"init": _flat_params(trainer.model).cpu(), "init_stats": _stats(trainer.model),
          "params": [], "grads": [], "stats": [], "losses": []}
    ae_digest = _digest(trainer.model)
    frames = prepare_batch(*(batch[k].cuda() for k in ("source", "driving")), augment)
    gm = torch.Generator(device="cuda").manual_seed(65)
    moved = {k: v * (1 + AE_ROUGH_EPS * torch.randn(v.shape, generator=gm, device="cuda"))
             for k, v in zip(("source", "driving"), frames)}
    for i, (inputs, aug) in enumerate(((batch, augment), (moved, None))):
        if i:  # the seeded init again, augmenting nothing: the frames are augmented
            trainer = ae_model_and_trainer(dict(acfg, device_augment=None), "cuda")
        with tf32_off():
            aux = trainer.train_step(None, {k: v.cuda() for k, v in inputs.items()}, tps=tps,
                                     augment=aug)
            torch.cuda.synchronize()
        ae["params"].append(_flat_params(trainer.model).cpu())
        ae["grads"].append(_flat_grads(trainer.model))
        ae["stats"].append(_stats(trainer.model))
        ae["losses"].append({k: v.item() for k, v in aux.items()})
        del trainer
    ae_inputs = {"digest": ae_digest, "batch": batch,
                 "augment": {k: v if not torch.is_tensor(v) else v.cpu()
                             for k, v in augment.items()},
                 "tps": tuple(None if v is None else v.cpu() for v in tps)}
    torch.cuda.empty_cache()
    torch.save({"dm": dm_inputs, "ae": ae_inputs}, Path(tmp) / "dp_inputs.pt")
    return {"dm": dm, "ae": ae}


def dp_rank(rank, world, backend, tmp):
    """One rank of phase "DP": joins the group over `backend` (a file store
    in `tmp`), runs the DM step, the sharded sampler (on the DM step's
    model) and the AE step on its rows with the counters from 0 before
    each, and writes what it measured to <tmp>/dp_rank<r>.pt."""
    from extdm_tpu_torch.config import kth_ae_training_config, kth_training_config
    from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusion
    from extdm_tpu_torch.models.lfae.transform import TPSTransform
    from extdm_tpu_torch.parallel import (init_data_group, make_data_group, rank_generator,
                                          shard_batch)
    from extdm_tpu_torch.train.device_augment import augment_rows
    from extdm_tpu_torch.train.dm_trainer import DMTrainer, make_optimizer

    w = init_data_group(backend, "cuda", rank=rank, world_size=world, local_rank=rank,
                        init_method=f"file://{tmp}/dp_store_{backend}")
    job_defaults()
    inp = torch.load(Path(tmp) / "dp_inputs.pt", weights_only=False)
    table = kernel_table()
    tables = {**table, **backward_table(table), **ae_backward_table(), **wm_table(table),
              **route_table()}
    counters = {n: k["wrapper"] for n, k in tables.items()}

    def counted(fn):
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return out, ms, {n: c.launches for n, c in counters.items()}

    def timed_steps(group, step):
        """DP_TIMED_STEPS steps: ms each (the first with the collectives
        untimed, the rest with each collective bracketed by syncs) and the
        collectives' ms of the timed ones."""
        times, timings = [], []
        for i in range(DP_TIMED_STEPS):
            group.timings = {} if i else None
            _, ms, _ = counted(step)
            times.append(ms)
            if i:
                timings.append(group.timings)
        return times, timings

    out = {"rank": rank, "device": str(w.device), "backend": backend,
           "device_name": torch.cuda.get_device_name(w.device)}
    # the DM step
    cfg = kth_training_config(torch.bfloat16)
    fd = FlowDiffusion(cfg, device=w.device, seed=0)
    if (_digest(fd.unet), _digest(fd.lfae)) != (inp["dm"]["unet_digest"],
                                                inp["dm"]["lfae_digest"]):
        raise AssertionError(f"DP rank {rank}: the seeded DM init differs from the parent's")
    group = make_data_group(DP_DM_BATCH, w)
    trainer = DMTrainer(fd, make_optimizer(fd.unet.parameters(), 2e-4, (500000,), 0.5), group)
    rows = group.rows(DP_DM_BATCH)
    video, t, noise = (v.to(w.device) for v in shard_batch(
        [inp["dm"][k] for k in ("video", "t", "noise")], group))
    aux, ms, launches = counted(lambda: trainer.train_step(None, video, t=t, noise=noise))
    out["dm"] = {"rows": [rows.start, rows.stop], "first_ms": ms, "launches": launches,
                 "loss": aux["loss"].item(), "params": _flat_params(fd.unet).cpu(),
                 "grads": _flat_grads(fd.unet),
                 "digest": _digest(fd.unet)}
    times, timings = timed_steps(group, lambda: trainer.train_step(None, video, t=t,
                                                                   noise=noise))
    out["dm"].update(ms=times, timings=timings)
    # the sharded sampler, on the DM step's model (the ranks' weights equal)
    cond = torch.rand((DP_SAMPLER_BATCH, cfg.cond_frames, cfg.frame_shape, cfg.frame_shape, 3),
                      generator=torch.Generator().manual_seed(65)).to(w.device)
    group = make_data_group(DP_SAMPLER_BATCH, w)
    rows = group.rows(DP_SAMPLER_BATCH)
    sharded = fd.make_sharded_sampler(group)
    gen = torch.Generator(device=w.device)
    group.timings = {}
    got, ms, launches = counted(lambda: sharded(gen.manual_seed(66), cond))
    own = [fd.make_sampler()(rank_generator(gen.manual_seed(66), group.rank), cond[rows])
           for _ in range(2)]
    check_sample(got, cfg, DP_SAMPLER_BATCH)
    lines = {}
    for key in got:
        mine = got[key][rows]
        if key.startswith("real_"):  # the encode repeats bit for bit
            lines[key] = torch.equal(mine, own[0][key]) or {"ok": False, "bitwise": False}
        else:
            lines[key] = _spread_check(mine.float(), own[0][key].float(), own[1][key].float(),
                                       None)
    gather_timings, group.timings = group.timings, None
    _, ms2, _ = counted(lambda: sharded(gen.manual_seed(67), cond))
    out["sampler"] = {"rows": [rows.start, rows.stop], "first_ms": ms, "ms": [ms2],
                      "launches": launches, "checks": lines, "timings": gather_timings}
    del fd, trainer, video, noise
    torch.cuda.empty_cache()

    # the AE step (SyncBN)
    acfg = kth_ae_training_config()
    group = make_data_group(DP_AE_BATCH, w)
    trainer = ae_model_and_trainer(acfg, w.device, group=group)
    if _digest(trainer.model) != inp["ae"]["digest"]:
        raise AssertionError(f"DP rank {rank}: the seeded AE init differs from the parent's")
    rows = group.rows(DP_AE_BATCH)
    batch = {k: v.to(w.device) for k, v in shard_batch(inp["ae"]["batch"], group).items()}
    augment = {k: v.to(w.device) if torch.is_tensor(v) else v
               for k, v in augment_rows(inp["ae"]["augment"], rows).items()}
    tps = TPSTransform(*(None if v is None else v.to(w.device) for v in inp["ae"]["tps"]))
    tps = tps.rows(rows)
    with tf32_off():
        aux, ms, launches = counted(lambda: trainer.train_step(None, batch, tps=tps,
                                                               augment=augment))
    stats = _stats(trainer.model)
    out["ae"] = {"rows": [rows.start, rows.stop], "first_ms": ms, "launches": launches,
                 "losses": {k: v.item() for k, v in aux.items()},
                 "params": _flat_params(trainer.model).cpu(), "stats": stats,
                 "grads": _flat_grads(trainer.model),
                 "digest": _digest(trainer.model)}
    times, timings = timed_steps(group, lambda: trainer.train_step(None, batch, tps=tps,
                                                                   augment=augment))
    out["ae"].update(ms=times, timings=timings)
    del trainer, batch
    torch.cuda.empty_cache()

    torch.save(out, Path(tmp) / f"dp_rank{rank}.pt")
    torch.distributed.destroy_process_group()


def dp_phase(card):
    """Phase "DP": the single-process references, then DP_RANKS ranks over
    gloo on cuda:0 (and over nccl, one a card, where there are enough
    cards); checks each step against its reference, the ranks' states
    against each other and every rank's launches against world 1's."""
    import tempfile

    import torch.multiprocessing as mp

    from extdm_tpu_torch.config import kth_training_config

    t_phase = time.perf_counter()
    cfg = kth_training_config(torch.bfloat16)
    want_fwd, want_bwd = expected_train_launches(cfg)
    want_dm = {**want_fwd, **want_bwd}
    want_ae = {"grid_sample": 6, "grid_sample_bwd": 5}
    want_sampler = expected_launches(cfg)
    backends = ["gloo"] + (["nccl"] if torch.cuda.device_count() >= DP_RANKS else [])
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ref = dp_reference(tmp)
        log({"phase": "DP reference", "seconds": time.perf_counter() - t0,
             "dm_loss": ref["dm"]["loss"], "ae_losses": ref["ae"]["losses"]})
        for backend in backends:
            t0 = time.perf_counter()
            ctx = mp.start_processes(dp_rank, args=(DP_RANKS, backend, tmp), nprocs=DP_RANKS,
                                     join=False, start_method="spawn")
            while not ctx.join(timeout=5.0):
                if time.perf_counter() - t0 > 600:
                    for p in ctx.processes:
                        p.kill()
                    raise TimeoutError(f"DP ranks over {backend} still running after 600 s")
            spawn_s = time.perf_counter() - t0
            got = [torch.load(Path(tmp) / f"dp_rank{r}.pt", weights_only=False)
                   for r in range(DP_RANKS)]
            dp_check(got, ref, backend, spawn_s, want_dm, want_ae, want_sampler, card)
        log({"phase": "DP phase", "seconds": time.perf_counter() - t_phase, "backends": backends})
        tp_phase(ref["dm"], tmp, want_dm, card)


def dp_check(got, ref, backend, spawn_s, want_dm, want_ae, want_sampler, card):
    """Phase "DP"'s lines and checks for one backend's ranks: every line is
    printed before a failed check raises."""
    dm, ae = ref["dm"], ref["ae"]
    checks, failed = {}, []
    for part, want in (("dm", want_dm), ("ae", want_ae), ("sampler", want_sampler)):
        for g in got:
            seen = {n: c for n, c in g[part]["launches"].items() if c}
            if seen != want:
                failed.append(f"rank {g['rank']} {part} launches {seen} != world 1's {want}")
    for part in ("dm", "ae"):
        checks[f"{part}_ranks_equal"] = got[0][part]["digest"] == got[1][part]["digest"]
        if not checks[f"{part}_ranks_equal"]:
            failed.append(f"{part}: the ranks' parameters differ after the step")
    for g in got:
        failed += [f"rank {g['rank']} sampler {k}" for k, line in g["sampler"]["checks"].items()
                   if line is not True and not line["ok"]]

    def held(name, got_, first, again, base):
        checks[name] = _spread_check(got_, first, again, base)
        if not checks[name]["ok"]:
            failed.append(name)

    held("dm_params", got[0]["dm"]["params"], dm["params"][0], dm["params"][1], dm["init"])
    held("dm_grads", got[0]["dm"]["grads"], dm["grads"][0], dm["grads"][1], None)
    held("dm_loss", torch.tensor(got[0]["dm"]["loss"]), torch.tensor(dm["loss"][0]),
         torch.tensor(dm["loss"][1]), None)
    # the AE against its step on frames moved by AE_ROUGH_EPS
    held("ae_params", got[0]["ae"]["params"], ae["params"][0], ae["params"][1], ae["init"])
    held("ae_grads", got[0]["ae"]["grads"], ae["grads"][0], ae["grads"][1], None)
    held("ae_running_stats", got[0]["ae"]["stats"], ae["stats"][0], ae["stats"][1],
         ae["init_stats"])
    for k in ae["losses"][0]:
        held(f"ae_{k}", torch.tensor(got[0]["ae"]["losses"][k]),
             torch.tensor(ae["losses"][0][k]), torch.tensor(ae["losses"][1][k]), None)

    def ms_of(timings, kind):
        return [sum(t.get(kind, [])) for t in timings]

    for g in got:
        log({"phase": "DP", "backend": backend, "rank": g["rank"], "device": g["device"],
             "device_name": g["device_name"], "ranks": DP_RANKS,
             "note": "ranks share one card over gloo (host-staged all-reduce): a smoke, not a "
                     "scaling figure" if backend == "gloo" and g["device"] == got[0]["device"]
                     else "one rank a card",
             "dm_step": {"global_batch": DP_DM_BATCH, "rows": g["dm"]["rows"],
                         "first_ms": g["dm"]["first_ms"], "ms": g["dm"]["ms"],
                         "grad_allreduce_ms": ms_of(g["dm"]["timings"], "grad"),
                         "aux_allreduce_ms": ms_of(g["dm"]["timings"], "aux"),
                         "launches": {n: c for n, c in g["dm"]["launches"].items() if c}},
             "ae_step": {"global_batch": DP_AE_BATCH, "rows": g["ae"]["rows"],
                         "first_ms": g["ae"]["first_ms"], "ms": g["ae"]["ms"],
                         "grad_allreduce_ms": ms_of(g["ae"]["timings"], "grad"),
                         "syncbn_allreduce_ms": ms_of(g["ae"]["timings"], "bn"),
                         "syncbn_allreduces": [len(t.get("bn", [])) for t in g["ae"]["timings"]],
                         "loss_allreduce_ms": ms_of(g["ae"]["timings"], "loss"),
                         "launches": {n: c for n, c in g["ae"]["launches"].items() if c}},
             "sampler": {"global_batch": DP_SAMPLER_BATCH, "rows": g["sampler"]["rows"],
                         "first_ms": g["sampler"]["first_ms"], "ms": g["sampler"]["ms"],
                         "gather_ms": sum(g["sampler"]["timings"].get("gather", [])),
                         "launches": {n: c for n, c in g["sampler"]["launches"].items() if c},
                         "vs_plain_on_own_rows": g["sampler"]["checks"]},
             "card": card})
    log({"phase": "DP checks", "backend": backend, "spawn_seconds": spawn_s, "checks": checks,
         "card": card})
    if failed:
        raise AssertionError(f"DP {backend}: {failed} outside the single-process step's spread")


# ------------------------------------------------------------------- TP
# Phase "TP": the tensor-parallel DM step (DMTrainer(mesh=...),
# parallel/tensor.py): each rank stores its slice of every weight JAX's rule
# splits and AdamW's moments for it, gathers the whole weights before the
# forward and averages the whole gradient over the world after the
# backward. On one card, over gloo (host-staged all-reduces): KTH at bf16,
# batch DP_DM_BATCH, from the seeded init, with DP's single-process step as
# the reference, at (data 1, model 2) on 2 ranks and on the hybrid (dcn 2,
# data 1, model 2) mesh on 4 ranks. Checks: each rank's launches on its
# first step equal world 1's; the updated parameters (gathered whole)
# against the single step by _spread_check (SPREAD_MULT times the single
# step's repeat spread plus one bf16 ulp of its mean update); the replicated
# leaves bit-identical across the ranks. Prints ms per step (the first, and
# a second with the exchanges' ms by kind: tp_gather, grad, aux), each rank's resident
# parameter + moment bytes beside the single process's, and its peak memory.
TP_MESHES = ((2, 1), (4, 2))  # (ranks, dcn); model 2
TP_MODEL = 2
TP_LIMIT_S = 600


def tp_rank(rank, world, dcn, tmp):
    """One rank of phase "TP": the mesh, the seeded model, one counted step
    on its data row's rows, then one timed step with its exchanges timed (a
    sync before and after each); writes <tmp>/tp_<world>_rank<r>.pt."""
    from extdm_tpu_torch.config import kth_training_config
    from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusion
    from extdm_tpu_torch.parallel import (init_data_group, make_hybrid_mesh, make_spatial_mesh,
                                          resident_bytes)
    from extdm_tpu_torch.train.dm_trainer import DMTrainer, make_optimizer

    w = init_data_group("gloo", "cuda", rank=rank, world_size=world, local_rank=rank,
                        init_method=f"file://{tmp}/tp_store_{world}")
    job_defaults()
    inp = torch.load(Path(tmp) / "dp_inputs.pt", weights_only=False)["dm"]
    table = kernel_table()
    counters = {n: k["wrapper"] for n, k in {**table, **backward_table(table)}.items()}
    cfg = kth_training_config(torch.bfloat16)
    fd = FlowDiffusion(cfg, device=w.device, seed=0)
    if (_digest(fd.unet), _digest(fd.lfae)) != (inp["unet_digest"], inp["lfae_digest"]):
        raise AssertionError(f"TP rank {rank}: the seeded DM init differs from the parent's")
    mesh = (make_hybrid_mesh(w, dcn, TP_MODEL) if dcn > 1
            else make_spatial_mesh(w, world // TP_MODEL, TP_MODEL))
    trainer = DMTrainer(fd, make_optimizer(fd.unet.parameters(), 2e-4, (500000,), 0.5),
                        mesh=mesh)
    rows = mesh.rows(DP_DM_BATCH)
    video, t, noise = (inp[k][rows].to(w.device) for k in ("video", "t", "noise"))

    def step():
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aux = trainer.train_step(None, video, t=t, noise=noise)
        torch.cuda.synchronize()
        return aux, (time.perf_counter() - t0) * 1e3, {n: c.launches for n, c in counters.items()}

    torch.cuda.reset_peak_memory_stats()
    aux, first_ms, launches = step()
    tp = trainer.tp
    whole = tp.state_dict()
    out = {"rank": rank, "place": [mesh.d, mesh.m, mesh.dcn], "rows": [rows.start, rows.stop],
           "first_ms": first_ms, "launches": launches, "loss": aux["loss"].item(),
           "params": torch.cat([whole[n].detach().float().reshape(-1).cpu() for n in tp.names]),
           "replicated_digest": [_digest_tensor(tp.params[n]) for n in tp.names
                                 if n not in tp.axes],
           "ruled": len(tp.axes), "replicated": len(tp.names) - len(tp.axes),
           "resident_bytes": resident_bytes(trainer.optimizer),
           "peak_bytes": torch.cuda.max_memory_allocated()}
    del whole
    mesh.timings = {}
    out["ms"] = [step()[1]]
    out["exchange_ms"] = {k: sum(v) for k, v in mesh.timings.items()}
    out["exchanges"] = {k: len(v) for k, v in mesh.timings.items()}
    mesh.timings = None
    torch.save(out, Path(tmp) / f"tp_{world}_rank{rank}.pt")
    torch.distributed.destroy_process_group()


def tp_phase(ref, tmp, want_dm, card):
    """Phase "TP": TP_MESHES on one card over gloo, against DP's
    single-process DM step `ref` (whose inputs are in <tmp>/dp_inputs.pt)."""
    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    failed = []
    for world, dcn in TP_MESHES:
        t0 = time.perf_counter()
        ctx = mp.start_processes(tp_rank, args=(world, dcn, tmp), nprocs=world, join=False,
                                 start_method="spawn")
        while not ctx.join(timeout=5.0):
            if time.perf_counter() - t0 > TP_LIMIT_S:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"TP ranks at world {world} still running after "
                                   f"{TP_LIMIT_S} s")
        spawn_s = time.perf_counter() - t0
        got = [torch.load(Path(tmp) / f"tp_{world}_rank{r}.pt", weights_only=False)
               for r in range(world)]
        mesh = ({"dcn": dcn, "data": world // (dcn * TP_MODEL), "model": TP_MODEL} if dcn > 1
                else {"data": world // TP_MODEL, "model": TP_MODEL})
        for g in got:
            seen = {n: c for n, c in g["launches"].items() if c}
            if seen != want_dm:
                failed.append(f"world {world} rank {g['rank']} launches {seen} != world 1's "
                              f"{want_dm}")
            line = _spread_check(g["params"], ref["params"][0], ref["params"][1], ref["init"])
            if not line["ok"]:
                failed.append(f"world {world} rank {g['rank']} params {line}")
            if g["replicated_digest"] != got[0]["replicated_digest"]:
                failed.append(f"world {world} rank {g['rank']}: replicated leaves differ from "
                              "rank 0's")
            log({"phase": "TP", "mesh": mesh, "rank": g["rank"], "place": g["place"],
                 "rows": g["rows"], "global_batch": DP_DM_BATCH,
                 "note": "ranks share one card over gloo (host-staged all-reduce): a smoke, "
                         "not a scaling figure",
                 "first_ms": g["first_ms"], "ms": g["ms"],
                 "exchange_ms": g["exchange_ms"], "exchanges": g["exchanges"],
                 "loss": g["loss"], "single_loss": ref["loss"][0],
                 "params_vs_single_step": line,
                 "replicated_bit_identical": g["replicated_digest"] == got[0]["replicated_digest"],
                 "ruled_tensors": g["ruled"], "replicated_tensors": g["replicated"],
                 "resident_bytes": g["resident_bytes"],
                 "single_process_resident_bytes": ref["resident_bytes"][0],
                 "resident_share": g["resident_bytes"] / ref["resident_bytes"][0],
                 "peak_bytes": g["peak_bytes"],
                 "launches": {n: c for n, c in g["launches"].items() if c}, "card": card})
        log({"phase": "TP checks", "mesh": mesh, "spawn_seconds": spawn_s, "failed": failed,
             "card": card})
    log({"phase": "TP phase", "seconds": time.perf_counter() - t_phase})
    if failed:
        raise AssertionError(f"TP: {failed}")


# ------------------------------------------------------------------ spatial
# Phase "spatial": the spatial (sequence-parallel) sampler,
# FlowDiffusion.make_spatial_sampler over a (data, model) mesh of spawned
# ranks: the batch over the data ranks, the latent H over the model ranks,
# every halo, statistic and gather an all-reduce (parallel/spatial.py). On
# one card SPATIAL_RANKS ranks share it over gloo (data 1 x model 2): a
# smoke of the exchanges and of each rank's kernels on its rows, not a
# scaling figure (gloo stages every all-reduce through host memory). With 2
# cards the ranks also run over nccl one a card, with 4 cards as (2, 2).
# Checks, for the KTH sampler in bf16 at batch SPATIAL_BATCH:
# - kernel 1 on a shard's windows (the global mask table, the ids cut to the
#   shard's H windows, the H roll done outside): each shard's output against
#   the plain layer on the same inputs, and the shards put back together
#   against the plain layer on the global tensor, at KTH shapes with the
#   UNet's shift (2, 2, 2) and an H-only shift (0, 2, 0);
# - each rank's denoiser forward on its rows (one UNet call on the encoded
#   latents) against the single process's forward: max|diff| <=
#   SPATIAL_MAX_REL_TOL * max(1, max|ref|), mean|diff| <=
#   SPATIAL_MEAN_REL_TOL * mean|ref|;
# - each rank's sampler result (the global dict) against the world-1
#   spatial call on the same generator, and that against make_sampler, by
#   the same two limits, each widened by SPREAD_MULT times make_sampler's
#   own difference from a second call on the same seed (kernel 3's
#   GroupNorm atomics do not repeat bit for bit, and ten bf16 DDIM steps
#   carry any last-bit difference into visible ones; see SPREAD_MULT); the
#   decoded pixels by the mean limit alone (their max is printed): the warp
#   multiplies a flow's last-bit differences by the image's slope (on the
#   CPU at a tiny model, world-1 spatial vs make_sampler moved a pixel by
#   0.05-0.07 where the flows moved by 0.009);
# - per rank: launches of kernels 1/2/3/4/9 on a call (180 / 91 / 0 / 5 / 0:
#   the resnet blocks run as resnet_block_sharded, convs and GroupNorm in
#   torch, as JAX's spatial sampler runs them on XLA), ms per call (median of
#   SPATIAL_TIMED_CALLS["kth"]), the exchanges' ms and counts by kind on one more
#   call, and the peak device memory against the single process's;
# - one configs/DM/cityscapes.yaml call at 128 px (a 64 x 64 latent: every
#   level's windows within the shards), batch SPATIAL_CITY_BATCH: its result
#   by the mean limit against the single process's, and the peak memory;
# - the w_ref/traj preset (kth_traj_config, bf16, batch SPATIAL_BATCH):
#   TrajWarp on each shard's query rows against the whole cond features and
#   the clamped halo of its resize (exchange kind "traj", one a DDIM step),
#   kernel 1 at N = 32 on the shards' cut window ids; each rank's result
#   against the single process's make_sampler by the same limits widened by
#   make_sampler's repeat spread; launches per call (180 / 90 / 0 / 5 / 0),
#   ms per call (one timed call), the exchanges by kind and the peak memory
#   as for KTH.
SPATIAL_RANKS = 2
SPATIAL_BATCH = 4
SPATIAL_CITY_BATCH = 2
# timed calls a rank makes of each model (none: the cityscapes call is
# held and its memory read, no more)
SPATIAL_TIMED_CALLS = {"kth": 3, "traj": 1}
SPATIAL_LIMIT_S = 600
SPATIAL_MAX_REL_TOL = 2.0 ** -5
SPATIAL_MEAN_REL_TOL = 2.0 ** -6
# (shape, shift, dtype, window) of kernel 1 on a shard's windows: KTH's
# first two levels at model 2 (16 and 8 rows a shard), window (4, 4, 4), 8
# heads of 32, in bf16 (stw_layer.cu), one float32 case (attention.cu's
# body), and the w_ref/traj preset's window (2, 4, 4) (N = 32, shift (1, 2,
# 2)) at its first two levels.
SPATIAL_K1_CASES = [((4, 30, 32, 32, 64), (2, 2, 2), torch.bfloat16, (4, 4, 4)),
                    ((4, 30, 32, 32, 64), (0, 2, 0), torch.bfloat16, (4, 4, 4)),
                    ((4, 30, 16, 16, 128), (2, 2, 2), torch.bfloat16, (4, 4, 4)),
                    ((1, 6, 16, 8, 64), (2, 2, 2), torch.float32, (4, 4, 4)),
                    ((4, 30, 32, 32, 64), (1, 2, 2), torch.bfloat16, (2, 4, 4)),
                    ((4, 30, 16, 16, 128), (1, 2, 2), torch.bfloat16, (2, 4, 4))]
# the models of the phase: name -> which config (spatial_config)
SPATIAL_MODELS = ("kth", "city", "traj")
CITYSCAPES_YAML = Path(__file__).resolve().parent / "configs" / "DM" / "cityscapes.yaml"


def spatial_config(name="kth"):
    from extdm_tpu_torch.config import (dm_config_from_yaml, kth_sampling_config,
                                        kth_traj_config, load_config)

    if name == "city":
        return dm_config_from_yaml(load_config(str(CITYSCAPES_YAML)), dtype=torch.bfloat16)
    if name == "traj":
        return kth_traj_config()
    return kth_sampling_config(dtype=torch.bfloat16)


def spatial_expected(cfg):
    """A spatial rank's launches per sampler call: every STW and temporal
    layer on its rows, the encode and decode's grid samples, no resnet
    block on kernel 3 and no other kernel (layout "0")."""
    return {**expected_launches(cfg), "resnet_block": 0}


PIXEL_KEYS = ("sample_out_vid", "sample_warped_vid")


def _diff(got, ref):
    diff = (got.float() - ref.float()).abs()
    return diff.max().item(), diff.mean().item()


def spatial_limits(name, got, ref, spread=None) -> dict:
    """max|got - ref| against SPATIAL_MAX_REL_TOL * max(1, max|ref|) (but
    for decoded pixels, PIXEL_KEYS in `name`) and mean|got - ref| against
    SPATIAL_MEAN_REL_TOL * mean|ref|, each plus SPREAD_MULT times `spread`
    (make_sampler's (max, mean) difference from itself) where given."""
    got, ref = got.float(), ref.float()
    if not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
        return {"what": name, "ok": False, "finite": False}
    err_max, err_mean = _diff(got, ref)
    spread = spread or (0.0, 0.0)
    line = {"what": name, "max_abs_err": err_max,
            "max_tol": (SPATIAL_MAX_REL_TOL * max(1.0, ref.abs().max().item())
                        + SPREAD_MULT * spread[0]),
            "mean_abs_err": err_mean,
            "mean_tol": SPATIAL_MEAN_REL_TOL * ref.abs().mean().item() + SPREAD_MULT * spread[1],
            "spread": list(spread)}
    line["max_held"] = not any(k in name for k in PIXEL_KEYS)
    line["ok"] = ((line["max_abs_err"] <= line["max_tol"] or not line["max_held"])
                  and line["mean_abs_err"] <= line["mean_tol"])
    return line


def spatial_kernel1_phase(card, model=2):
    """Kernel 1 on a shard's windows, at SPATIAL_K1_CASES, shards run in
    this process (each given the rows the cyclic halo would give it)."""
    from extdm_tpu_torch.ops import fused_stw

    g = torch.Generator(device="cuda").manual_seed(81)
    heads, dh = 8, 32
    hid = heads * dh

    def randn(*s, scale=1.0):
        return scale * torch.randn(s, generator=g, device="cuda")

    for shape, shift, dtype, window in SPATIAL_K1_CASES:
        N = math.prod(window)
        B, T, H, W, C = shape
        x = randn(*shape).to(dtype)
        rel, residual = (BF16_REL_TOL, True) if dtype == torch.bfloat16 else (F32_REL_TOL, False)
        params = (1.0 + randn(C, scale=0.1), randn(3 * hid, C, scale=0.05),
                  randn(C, hid, scale=0.05), randn(C, scale=0.05), randn(heads, N, N, scale=0.1))
        kw = dict(window=window, heads=heads, dim_head=dh)
        full = fused_stw.stw_layer_plain(x, *params, shift=shift, **kw)
        sh, HL = shift[1], H // model
        pd, _, pw = fused_stw._pads(T, H, W, window)
        local_shift = (shift[0], 0, shift[2])
        rolled = torch.roll(x, -sh, dims=2)
        outs, shards = [], []
        for m in range(model):
            mask = fused_stw.shard_mask_tables(T + pd, H, W + pw, window, tuple(shift), m, model,
                                               x.device)
            local = rolled[:, :, m * HL:(m + 1) * HL].contiguous()
            before = fused_stw.fused_stw_layer.launches
            k = fused_stw.fused_stw_layer(local, *params, shift=local_shift, mask=mask, **kw)
            torch.cuda.synchronize()
            if fused_stw.fused_stw_layer.launches != before + 1:
                raise AssertionError("kernel 1 with cut ids: the wrapper launched no kernel")
            p = fused_stw.stw_layer_plain(local, *params, shift=local_shift, mask=mask, **kw)
            shards.append(check(f"kernel 1 cut ids {shape} {shift} shard {m}", k, p, rel,
                                residual=local if residual else None))
            outs.append(k)
        joined = torch.roll(torch.cat(outs, dim=2), sh, dims=2)
        whole = check(f"kernel 1 cut ids {shape} {shift} joined", joined, full, rel,
                      residual=x if residual else None)
        mask = fused_stw.shard_mask_tables(T + pd, H, W + pw, window, tuple(shift), 0, model,
                                           x.device)
        local = rolled[:, :, :HL].contiguous()
        log({"phase": "spatial kernel 1", "shape": list(shape), "shift": list(shift),
             "window": list(window), "tokens": N, "dtype": str(dtype),
             "model": model, "local_shape": list(local.shape), "mask_tables": list(mask[0].shape),
             "ids": mask[1].numel(), "shards": shards, "joined_vs_global_plain": whole,
             "kernel_ms": cuda_ms(lambda: fused_stw.fused_stw_layer(
                 local, *params, shift=local_shift, mask=mask, **kw), 5),
             "plain_ms": cuda_ms(lambda: fused_stw.stw_layer_plain(
                 local, *params, shift=local_shift, mask=mask, **kw), 3),
             "card": card})


def _peak_call(fn):
    """fn()'s result, the peak device memory (bytes) of the call and that
    peak less the memory held before it: the call's own working memory
    (the weights, the inputs and whatever the caller holds left out)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return out, peak, peak - before


def _host(out):
    return {k: None if v is None else v.float().cpu() for k, v in out.items()}


def spatial_reference(tmp):
    """The single process's results, on the card, for each of
    SPATIAL_MODELS: the model's encode of the cond videos and one denoiser
    forward on random noisy latents, two make_sampler calls and one world-1
    spatial call on the same seed (with their peak memory); writes the
    ranks' inputs to <tmp>/spatial_inputs.pt and returns the references (on
    the host)."""
    from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusion
    from extdm_tpu_torch.parallel import World, make_spatial_mesh

    ref, inputs = {}, {}
    world1 = World(rank=0, size=1, local_rank=0, device=torch.device("cuda", 0), backend="gloo")
    for name in SPATIAL_MODELS:
        cfg = spatial_config(name)
        fd = FlowDiffusion(cfg, device="cuda", seed=0)
        B = SPATIAL_CITY_BATCH if name == "city" else SPATIAL_BATCH
        px = cfg.frame_shape
        cond = torch.rand((B, cfg.cond_frames, px, px, 3),
                          generator=torch.Generator().manual_seed(71)).cuda()
        gen = torch.Generator(device="cuda")
        plain = fd.make_sampler()
        with torch.no_grad():
            enc, fea, x_cond = fd._encode(cond)
            x = torch.randn((B, cfg.pred_frames, *x_cond.shape[2:]),
                            generator=torch.Generator().manual_seed(72)).cuda()
            t = torch.tensor([500] * B, device="cuda")
            unet = fd.sampling_unet()
            unet(x, t, x_cond, fea)  # warm
            forward, _, forward_work = _peak_call(lambda: unet(x, t, x_cond, fea))
        plain(gen.manual_seed(73), cond)  # warm
        first, peak, work = _peak_call(lambda: plain(gen.manual_seed(73), cond))
        again = plain(gen.manual_seed(73), cond)
        spatial1 = fd.make_spatial_sampler(make_spatial_mesh(world1, 1, 1))
        one, _, work1 = _peak_call(lambda: spatial1(gen.manual_seed(73), cond))
        first, again = _host(first), _host(again)
        ref[name] = {"plain": first, "world1": _host(one), "forward": forward.float().cpu(),
                     "forward_work": forward_work, "work": work, "world1_work": work1,
                     "spread": {k: _diff(again[k], v) for k, v in first.items() if v is not None},
                     "peak": peak}
        inputs[name] = {"cond": cond.cpu(), "x": x.cpu(), "t": t.cpu(), "x_cond": x_cond.cpu(),
                        "fea": None if fea is None else fea.cpu(),
                        "digest": (_digest(fd.unet), _digest(fd.lfae))}
        del fd, plain, spatial1, unet, enc
        torch.cuda.empty_cache()
    torch.save(inputs, Path(tmp) / "spatial_inputs.pt")
    return ref


def spatial_rank(rank, world, backend, data, tmp):
    """One rank of phase "spatial": joins the group over `backend`, makes
    the (data, world / data) mesh and runs ``spatial_rank_calls`` on the KTH
    model, the cityscapes call and the traj model, the counters from 0
    before each call. Writes what it measured to
    <tmp>/spatial_<backend>_rank<r>.pt."""
    from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusion
    from extdm_tpu_torch.parallel import init_data_group, make_spatial_mesh

    w = init_data_group(backend, "cuda", rank=rank, world_size=world, local_rank=rank,
                        init_method=f"file://{tmp}/spatial_store_{backend}_{world}")
    job_defaults()
    inp = torch.load(Path(tmp) / "spatial_inputs.pt", weights_only=False)
    table = kernel_table()
    tables = {**table, **wm_table(table), **route_table()}
    counters = {n: k["wrapper"] for n, k in tables.items()}

    def counted(fn):
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3, {n: c.launches for n, c in counters.items()}

    out = {"rank": rank, "device": str(w.device), "backend": backend,
           "device_name": torch.cuda.get_device_name(w.device)}
    mesh = make_spatial_mesh(w, data, world // data)
    out["place"] = [mesh.d, mesh.m]
    for name in SPATIAL_MODELS:
        cfg, case = spatial_config(name), inp[name]
        fd = FlowDiffusion(cfg, device=w.device, seed=0)
        if (_digest(fd.unet), _digest(fd.lfae)) != case["digest"]:
            raise AssertionError(f"spatial rank {rank}: the seeded init differs from the parent's")
        out[name] = spatial_rank_calls(fd, mesh, case, counted, SPATIAL_TIMED_CALLS.get(name))
        del fd
        torch.cuda.empty_cache()
    torch.save(out, Path(tmp) / f"spatial_{backend}_rank{rank}.pt")
    torch.distributed.destroy_process_group()


def spatial_rank_calls(fd, mesh, case, counted, calls):
    """A rank's calls on one model: a counted first call, then, where
    `calls` is given, one denoiser forward on the rank's rows, `calls`
    timed calls and one with the exchanges timed (its peak memory), else
    one more call (its peak memory)."""
    dev = fd.device
    cond = case["cond"].to(dev)
    sampler = fd.make_spatial_sampler(mesh)
    gen = torch.Generator(device=dev)
    res = {}
    got, res["first_ms"], res["launches"] = counted(lambda: sampler(gen.manual_seed(73), cond))
    res["out"] = _host(got)
    if calls is None:
        _, res["peak"], res["work"] = _peak_call(lambda: sampler(gen.manual_seed(73), cond))
        return res
    rows = mesh.rows(cond.shape[0])
    args = (mesh.local(case["x"].to(dev)), case["t"].to(dev)[rows],
            mesh.local(case["x_cond"].to(dev)), case["fea"].to(dev)[rows])
    unet = fd.sampling_unet()
    with torch.no_grad():
        unet(*args, shard=mesh)  # warm
        y, _, res["forward_work"] = _peak_call(lambda: unet(*args, shard=mesh))
    h_rows = mesh.h_rows(y.shape[2] * mesh.model)
    res.update(forward=y.float().cpu(), rows=[rows.start, rows.stop],
               h_rows=[h_rows.start, h_rows.stop], ms=[], timed_launches=[])
    for _ in range(calls):
        _, ms, launches = counted(lambda: sampler(gen.manual_seed(73), cond))
        res["ms"].append(ms)
        res["timed_launches"].append(launches)
    mesh.timings = {}
    (_, res["exchanges_timed_call_ms"], _), res["peak"], res["work"] = _peak_call(
        lambda: counted(lambda: sampler(gen.manual_seed(73), cond)))
    timings, mesh.timings = mesh.timings, None
    res["exchange_ms"] = {k: sum(v) for k, v in timings.items()}
    res["exchanges"] = {k: len(v) for k, v in timings.items()}
    return res


def spatial_phase(card):
    """Phase "spatial": kernel 1 on cut ids, the single-process references,
    then the ranks over gloo on cuda:0 (and over nccl, one a card, where
    there are 2 or 4 cards); checks and prints each rank's lines. Returns
    rank 0's launches per KTH call and per traj call over gloo."""
    import tempfile

    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    spatial_kernel1_phase(card)
    cards = torch.cuda.device_count()
    runs = [("gloo", SPATIAL_RANKS, 1)]
    if cards >= 4:
        runs.append(("nccl", 4, 2))
    elif cards >= 2:
        runs.append(("nccl", 2, 1))
    first = None
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ref = spatial_reference(tmp)
        keys = [(n, k) for n, r in ref.items() for k in r["spread"]]
        world1 = [spatial_limits(f"{n} {k}", ref[n]["world1"][k], ref[n]["plain"][k],
                                 ref[n]["spread"][k]) for n, k in keys]
        log({"phase": "spatial reference", "seconds": time.perf_counter() - t0,
             "peak_bytes": {n: r["peak"] for n, r in ref.items()},
             "working_bytes": {n: r["work"] for n, r in ref.items()},
             "world1_spatial_working_bytes": {n: r["world1_work"] for n, r in ref.items()},
             "world1_vs_make_sampler": world1,
             "make_sampler_repeat_max_mean": {f"{n} {k}": ref[n]["spread"][k] for n, k in keys},
             "card": card})
        failed = [line for line in world1 if not line["ok"]]
        if failed:
            raise AssertionError(f"spatial: the world-1 spatial call differs from make_sampler "
                                 f"beyond a limit: {failed}")
        for backend, world, data in runs:
            t0 = time.perf_counter()
            ctx = mp.start_processes(spatial_rank, args=(world, backend, data, tmp),
                                     nprocs=world, join=False, start_method="spawn")
            while not ctx.join(timeout=5.0):
                if time.perf_counter() - t0 > SPATIAL_LIMIT_S:
                    for p in ctx.processes:
                        p.kill()
                    raise TimeoutError(f"spatial ranks over {backend} still running after "
                                       f"{SPATIAL_LIMIT_S} s")
            spawn_s = time.perf_counter() - t0
            got = [torch.load(Path(tmp) / f"spatial_{backend}_rank{r}.pt", weights_only=False)
                   for r in range(world)]
            spatial_check(got, ref, backend, world, data, spawn_s, card)
            if first is None:
                first = got[0]["kth"]["launches"], got[0]["traj"]["launches"]
    log({"phase": "spatial phase", "seconds": time.perf_counter() - t_phase,
         "runs": [list(r) for r in runs]})
    return first


def spatial_check(got, ref, backend, world, data, spawn_s, card):
    """Phase "spatial"'s lines and checks for one run of ranks: every line
    is printed before a failed check raises."""
    failed = []
    for g in got:
        kth, city, traj = g["kth"], g["city"], g["traj"]
        lines = {}
        for name in ("kth", "traj"):
            res = g[name]
            want = {n: c for n, c in spatial_expected(spatial_config(name)).items() if c}
            for what, seen in [("warm-up", res["launches"])] + [
                    (f"timed call {i}", s) for i, s in enumerate(res["timed_launches"])]:
                nonzero = {n: c for n, c in seen.items() if c}
                if nonzero != want:
                    failed.append(f"rank {g['rank']} {name} {what} launches {nonzero} != {want}")
            r0, r1 = res["rows"]
            h0, h1 = res["h_rows"]
            lines[f"{name} forward"] = spatial_limits("denoiser forward", res["forward"],
                                                      ref[name]["forward"][r0:r1, :, h0:h1])
        if traj["exchanges"].get("traj") != spatial_config("traj").sampling_timesteps:
            failed.append(f"rank {g['rank']} traj: {traj['exchanges'].get('traj')} warp halos "
                          "a call, not one a DDIM step")
        # the KTH and cityscapes calls against world 1's spatial call, the
        # traj call against the single process's make_sampler
        for name, res, against in (("kth", kth, "world1"), ("city", city, "world1"),
                                   ("traj", traj, "plain")):
            for key, v in res["out"].items():
                if v is None:
                    continue
                lines[f"{name} {key} vs {against}"] = spatial_limits(
                    key, v, ref[name][against][key], ref[name]["spread"][key])
                if name != "city" and key.startswith("real_") and data == 1:
                    lines[f"{name} {key} encode bitwise"] = {
                        "ok": torch.equal(v, ref[name]["plain"][key])}
        for what, line in lines.items():
            if not line["ok"]:
                failed.append(f"rank {g['rank']} {what}: {line}")
        log({"phase": "spatial", "backend": backend, "rank": g["rank"], "place": g["place"],
             "mesh": [data, world // data], "device": g["device"],
             "device_name": g["device_name"],
             "note": ("ranks share one card over gloo (host-staged all-reduce): a smoke, not a "
                      "scaling figure") if len({x["device"] for x in got}) == 1
             else f"one rank a card over {backend}",
             "kth": {"global_batch": SPATIAL_BATCH, "first_ms": kth["first_ms"], "ms": kth["ms"],
                     "median_ms": statistics.median(kth["ms"]),
                     "launches": {n: c for n, c in kth["launches"].items() if c},
                     "exchanges_timed_call_ms": kth["exchanges_timed_call_ms"],
                     "exchange_ms": kth["exchange_ms"], "exchanges": kth["exchanges"],
                     "peak_bytes": kth["peak"], "single_process_peak_bytes": ref["kth"]["peak"],
                     "working_bytes": kth["work"],
                     "single_process_working_bytes": ref["kth"]["work"],
                     "world1_spatial_working_bytes": ref["kth"]["world1_work"],
                     "unet_forward_working_bytes": kth["forward_work"],
                     "single_process_unet_forward_working_bytes": ref["kth"]["forward_work"]},
             "traj": {"global_batch": SPATIAL_BATCH, "first_ms": traj["first_ms"],
                      "ms": traj["ms"], "median_ms": statistics.median(traj["ms"]),
                      "launches": {n: c for n, c in traj["launches"].items() if c},
                      "exchanges_timed_call_ms": traj["exchanges_timed_call_ms"],
                      "exchange_ms": traj["exchange_ms"], "exchanges": traj["exchanges"],
                      "peak_bytes": traj["peak"], "single_process_peak_bytes": ref["traj"]["peak"],
                      "working_bytes": traj["work"],
                      "single_process_working_bytes": ref["traj"]["work"],
                      "unet_forward_working_bytes": traj["forward_work"],
                      "single_process_unet_forward_working_bytes":
                          ref["traj"]["forward_work"]},
             "cityscapes": {"global_batch": SPATIAL_CITY_BATCH, "first_ms": city["first_ms"],
                            "launches": {n: c for n, c in city["launches"].items() if c},
                            "peak_bytes": city["peak"], "working_bytes": city["work"],
                            "single_process_peak_bytes": ref["city"]["peak"],
                            "single_process_working_bytes": ref["city"]["work"],
                            "world1_spatial_working_bytes": ref["city"]["world1_work"]},
             "checks": lines, "card": card})
    log({"phase": "spatial checks", "backend": backend, "spawn_seconds": spawn_s,
         "failed": failed, "card": card})
    if failed:
        raise AssertionError(f"spatial {backend}: {failed}")


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
    wm, rt = wm_table(table), route_table()
    # layout "0": no window-major layer; every layer within the kernels' widths
    want = dict(want, stw_layer_wm=0, **{n: 0 for n in rt})
    times, launches = [], {}
    for i in range(TIMED_CALLS):
        for k in {**table, **wm, **rt}.values():
            k["wrapper"].launches = 0
        t0 = time.perf_counter()
        out = sampler(gen.manual_seed(100 + i), cond)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches = {n: k["wrapper"].launches for n, k in {**table, **wm, **rt}.items()}
        if launches != want:
            raise AssertionError(f"request {i}: kernel launches {launches} != expected {want}")
    B, tp = BATCH, cfg.pred_frames
    check_sample(out, cfg, B)
    med = statistics.median(times)
    log({"phase": "end to end", "config": "KTH 64px tc=10 tp=20 DDIM-10 bf16", "batch": B,
         "ms_per_call": [t * 1e3 for t in times], "median_ms": med * 1e3,
         "predicted_frames_per_s": B * tp / med, "launches_per_call": launches, "card": card})

    sampler_variants_phase(fd, cond, card)
    unet_f32_card_vs_cpu(cfg)
    del fd, sampler
    torch.cuda.empty_cache()

    # ---- the DM train path
    btable, ae_btable = backward_table(table), ae_backward_table()
    bsummary, train_launches, train_ms = train_phase(table, btable, card,
                                                     others={**ae_btable, **wm, **rt})

    # ---- the AE (stage-1) train path
    aesummary, ae_launches, ae_ms = ae_phase(table, btable, ae_btable, card,
                                             others={**wm, **rt})

    # ---- the two training jobs (train/train_dm.py and train/train_ae.py main)
    counters = {n: k["wrapper"] for n, k in {**table, **btable, **ae_btable, **wm, **rt}.items()}
    dm_job_phase(counters, card, train_ms)
    ae_job_phase(counters, card, ae_ms)

    # ---- the rest of the data feed: process workers, the clip cache, HDF5
    data_feed_phase(counters, card, train_ms, ae_ms)

    # ---- the evaluation artefacts and tools (kernel 4 in the encodes)
    gt_launches, v2v_launches = artefacts_phase(table, counters, card)

    # ---- the evaluation path (kernel 9)
    wsummary, eval_launches, eval_calls = eval_phase(table, btable, {**ae_btable, **rt}, card)

    # ---- the multi1248/ada preset (kernels 10-12 on the layers over 256 channels)
    msummary, m_call, m_step, m_f32, m_f32_step = multi1248_phase(table, btable,
                                                                  {**ae_btable, **wm}, card)

    # ---- the w_ref/traj preset (kernels 1 and 5 at N = 32), then the AE step in bf16
    _, traj_call = traj_sampling_phase(table, {**btable, **ae_btable, **wm, **rt}, card)
    _, traj_step = traj_train_phase(table, btable, {**ae_btable, **wm, **rt}, card)
    _, ae16_step = ae_bf16_phase(table, ae_btable, {**btable, **wm, **rt}, card, ae_ms)

    # ---- data parallel: the DM and AE steps and the sampler in 2 ranks; then
    # tensor parallel: the DM step on (data 1, model 2) and (dcn 2, data 1, model 2)
    job_defaults()
    torch.cuda.empty_cache()
    dp_phase(card)

    # ---- spatial: the sampler over ranks holding shards of the latent H
    torch.cuda.empty_cache()
    spatial_launches, spatial_traj_launches = spatial_phase(card)

    # each kernel's launches: on the sampling path for the forward kernels,
    # on the DM train path for its backward kernels, on the AE path for the
    # grid-sample backward, on the eval path (all its sampler calls) for
    # kernel 9, on the multi1248 path in float32 for kernels 10 and 11 (its
    # train step: the blocks over 256 channels, which kernel 7 takes in
    # bf16) and kernel 12 (its UNet forward: in bf16 no layer takes kernel 12
    # since kernels 2 and 6 took the 512-channel temporal layer); with the
    # DM, AE, eval and multi1248 counts of every kernel
    summaries = {**summary, **bsummary, **aesummary, **{"stw_layer_wm": wsummary}, **msummary}
    kernels = []
    for name, k in {**table, **btable, **ae_btable, **wm, **rt}.items():
        s = summaries[name]
        if name in rt:
            path_launches = m_f32_step[name] if name.startswith("conv33") else m_f32[name]
        elif name in wm:
            path_launches = eval_launches[name]
        else:
            path_launches = launches.get(
                name, train_launches[name] if name in btable else ae_launches[name])
        kernels.append({"name": name, "route": "cuda", "source": k["source"],
                        "replaces": k["replaces"], "launches": path_launches,
                        "train_step_launches": train_launches.get(name, 0),
                        "ae_step_launches": ae_launches.get(name, 0),
                        "eval_launches": eval_launches.get(name, 0),
                        "eval_sampler_calls": eval_calls,
                        "multi1248_call_launches": m_call[name],
                        "multi1248_step_launches": m_step[name],
                        "multi1248_f32_forward_launches": m_f32[name],
                        "multi1248_f32_step_launches": m_f32_step[name],
                        "traj_call_launches": traj_call.get(name, 0),
                        "traj_step_launches": traj_step.get(name, 0),
                        "ae_bf16_step_launches": ae16_step.get(name, 0),
                        "spatial_rank_call_launches": spatial_launches.get(name, 0),
                        "spatial_traj_rank_call_launches": spatial_traj_launches.get(name, 0),
                        "artefacts_gt_flow_launches": gt_launches.get(name, 0),
                        "video2video_launches": v2v_launches.get(name, 0),
                        "max_abs_err": s["max_abs_err"], "ms": s["ms"], "plain_ms": s["plain_ms"],
                        "bound_ms": s["bound_ms"],
                        "bound_by": "bytes" if s["bytes_ms"] >= s["ops_ms"] else "operations",
                        "library_ms": s["library_ms"],
                        **({f: s[f] for f in ("device_ms", "plain_device_ms",
                                              "library_device_ms")} if name in rt else {}),
                        **({"library_device_ms": s["library_device_ms"],
                            "wrapper_other_device_ms": s["other_device_ms"]}
                           if name in ("grid_sample", "grid_sample_bwd") else {}),
                        **({"device_ms": s["device_ms"],
                            "device_tflops": s["flops"] / s["device_ms"] / 1e9,
                            "bound_share": s["bound_ms"] / s["device_ms"]}
                           if name in DEVICE_TIMED else {}),
                        **({"parent_body_device_ms": s["parent_device_ms"]}
                           if "parent_device_ms" in s else {}),
                        **({"kernel1_same_layers_ms": s["kernel1_layer_ms"],
                            "kernel1_same_layers_device_ms": s["kernel1_device_ms"],
                            "layer_ms_with_partition": s["layer_ms"]} if name in wm else {})})
    log({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
