"""Traffic of kind ``sample``: a closed loop of calls to the program's
sampler (``FlowDiffusion.make_sampler()``), as ``valid_dm`` sends them.

The mix file gives ``rows`` (trajectories a call: one conditioning video
repeated, ``np.repeat`` order), and ``check_calls`` / ``check_rows`` (how
many calls and rows of each the check compares). Each video is rolled out
autoregressively to the configuration's ``test_pred_frames`` (whole calls,
rounded up): the first call is conditioned on the video's cond frames, each
next call on the last cond-frames of the previous call's predicted frames.
Video v's clip, call k's starting noise and call k's sampler generator come
from the seed, so a seed fixes all the work of a run.

The check runs the plain float32 reference, after the window, on the
chosen rows of the chosen calls: with the same cond frames the call was
given (for a call after the first of a video, the program's own earlier
frames: the check follows the rollout call by call), the same starting
noise and the same step noise (the sampler's generator replayed, one
draw of the whole batch a noisy step, as the sampler draws it). Rows are
independent in the sampler, so the reference runs only the chosen ones.
"""
from __future__ import annotations

import functools
import math
import random
import time

import torch

from portbench import program, weights
from portbench.cost.flops import sample_flops
from portbench.cost.kernels import trajwarp_cost
from portbench.harness import Run, Window

NOISE, SAMPLER = 2_000_000, 3_000_000  # generator streams of a call's noise and sampler


class Calls:
    """The inputs of the cell's calls, from the seed."""

    def __init__(self, run: Run):
        m = run.config["model"]
        self.run, self.rows = run, run.traffic["rows"]
        self.tc, self.tp, self.px, self.h = (m["cond_frames"], m["pred_frames"],
                                             m["frame_shape"], program.latent_size(m))
        self.rounds = math.ceil(run.config["test_pred_frames"] / self.tp)

    def first_cond(self, video: int) -> torch.Tensor:
        clip = weights.clips(self.run.seed, 1000 + video, 1, self.tc, self.px, self.run.device)
        return clip.repeat_interleave(self.rows, dim=0)

    def noise_shape(self):
        return (self.rows, self.tp, self.h, self.h, 3)

    def init_noise(self, k: int) -> torch.Tensor:
        g = weights.generator(self.run.seed, NOISE + k, self.run.device)
        return torch.randn(self.noise_shape(), generator=g, device=self.run.device)

    def sampler_generator(self, k: int) -> torch.Generator:
        return weights.generator(self.run.seed, SAMPLER + k, self.run.device)

    def check_rows(self) -> list:
        """The rows of every call that the check compares, drawn from the seed."""
        pick = random.Random(self.run.seed)
        return sorted(pick.sample(range(self.rows), self.run.traffic["check_rows"]))

    def next_cond(self, cond: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
        if pred.shape[1] >= self.tc:
            return pred[:, -self.tc:]
        return torch.cat([cond[:, pred.shape[1]:], pred], dim=1)


def prepare(run: Run) -> dict:
    fd = program.build(run)
    calls = Calls(run)
    sampler = fd.make_sampler()
    state = dict(fd=fd, sampler=sampler, calls=calls, rows=calls.check_rows(), records={})
    # warm-up: one call of the cell's shapes (kernel builds, allocator, libraries)
    sampler(calls.sampler_generator(-1), calls.first_cond(-1), init_noise=calls.init_noise(-1))
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    return state


def spans(state: dict, spans) -> None:
    fd = state["fd"]
    spans.layer(fd, "_encode", "encode")
    spans.layer(fd, "cond_cache", "cond_cache")
    spans.layer(fd.diffusion, "sample", "ddim")
    spans.layer(fd.lfae, "decode_flows", "decode")
    # the trajwarp family's feature warp, in the UNet that the sampler runs
    # (in bfloat16 a copy of fd.unet, made in the warm-up)
    warp = getattr(fd.sampling_unet(), "init_traj", None)
    if warp is not None:
        spans.op(warp, "forward", "trajwarp", functools.partial(trajwarp_cost, heads=warp.heads))


def call(state: dict, k: int, cond):
    """Call k: its cond frames (a video's first, or `cond`, the frames that
    continue it), the sampler, the check rows kept; returns the cond frames
    of the call that follows."""
    calls, rows, tc = state["calls"], state["rows"], state["calls"].tc
    video, r = divmod(k, calls.rounds)
    if r == 0:
        cond = calls.first_cond(video)
    out = state["sampler"](calls.sampler_generator(k), cond, init_noise=calls.init_noise(k))
    pred = out["sample_out_vid"][:, tc:].float()
    state["records"][k] = dict(
        round=r, cond=cond[rows].clone(), frames=pred[rows].clone(),
        flow=out["sample_vid_grid"][rows, tc:].float().clone(),
        conf=out["sample_vid_conf"][rows, tc:].float().clone())
    return calls.next_cond(cond, pred)


def measure(run: Run, state: dict) -> Window:
    calls, sync = state["calls"], run.device.type == "cuda"
    k, cond, last = 0, None, 0.0
    start = time.perf_counter()
    while time.perf_counter() - start < run.seconds:
        cond = call(state, k, cond)
        if sync:
            torch.cuda.synchronize(run.device)
        last = time.perf_counter()
        k += 1
    elapsed = last - start
    frames = k * calls.rows * calls.tp
    return Window(units=k, elapsed_s=elapsed,
                  rates={"sample_frames_per_s": frames / elapsed}, attempted=k, failed=0)


def release(state: dict) -> None:
    for key in ("fd", "sampler"):
        state.pop(key, None)


def chosen_calls(run: Run, records: dict) -> list:
    """`check_calls` completed calls drawn from the seed: first from the
    calls that start a video, then from those that continue one, in turn."""
    pick = random.Random(run.seed + 1)
    pools = [[k for k, rec in records.items() if rec["round"] == 0],
             [k for k, rec in records.items() if rec["round"] > 0]]
    chosen = []
    while len(chosen) < run.traffic["check_calls"] and any(pools):
        for pool in pools:
            if pool and len(chosen) < run.traffic["check_calls"]:
                chosen.append(pool.pop(pick.randrange(len(pool))))
    return sorted(chosen)


def reference_rows(ref, calls: Calls, k: int, rows: list, cond: torch.Tensor) -> dict:
    """The reference's flow, occlusion and frames of `rows` of call k."""
    noise = calls.init_noise(k)[rows]
    g = calls.sampler_generator(k)
    draws = {i: torch.randn(calls.noise_shape(), generator=g, device=calls.run.device)[rows]
             for i in ref.noise_steps()}
    with torch.no_grad():
        return ref.sample(cond, noise, draws.__getitem__)


def compare(got: dict, want: dict, ref, cond: torch.Tensor) -> dict:
    """The worst row's relative L2 error of the latents (flow and occlusion,
    as the sampler's latent holds them), of the decoded frames, and of the
    decode alone: `got`'s frames against the reference's decode of `got`'s
    own latents."""
    def rel(a, b):
        return ((a - b).flatten(1).norm(dim=1) / b.flatten(1).norm(dim=1)).max().item()
    lat = lambda d: torch.cat([d["flow"], d["conf"] * 2 - 1], dim=-1)  # noqa: E731
    with torch.no_grad():
        decoded = ref.lfae.decode_flows(cond[:, ref.tc - 1], got["flow"], got["conf"])["out_vid"]
    return {"latent_rel_l2": rel(lat(got), lat(want)),
            "frames_rel_l2": rel(got["frames"], want["frames"]),
            "decode_rel_l2": rel(got["frames"], decoded)}


def worst(readings: list) -> dict:
    return {k: max(r[k] for r in readings) for k in readings[0]}


def check(run: Run, state: dict, ref=None) -> dict:
    ref = ref or weights.reference(run.config["model"], run.seed, run.device)
    calls, rows, records = state["calls"], state["rows"], state["records"]
    readings = []
    for k in chosen_calls(run, records):
        rec = records[k]
        want = reference_rows(ref, calls, k, rows, rec["cond"])
        readings.append(compare(rec, want, ref, rec["cond"]))
    return worst(readings)


def unit_flops(run: Run) -> float:
    return sample_flops(run.config["model"], run.traffic["rows"])
