"""Profiling hooks (port of extdm_tpu/utils/profiler.py).

- ``trace(logdir)``: ``torch.profiler`` around a block (CPU, and CUDA where
  there is a card), written to `logdir` as a TensorBoard trace.
- ``device_timer``: wall time per call of a function, after warm-up calls,
  fenced by ``torch.cuda.synchronize()`` where the result holds a CUDA tensor.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable

import torch


@contextlib.contextmanager
def trace(logdir: str):
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def _fence(out) -> None:
    """Wait for the card where `out` (a tensor or a nest of them) holds a CUDA tensor."""
    if torch.is_tensor(out):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _fence(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _fence(v)


def device_timer(fn: Callable, *args, warmup: int = 1, repeats: int = 5, **kwargs):
    """(seconds per call over `repeats` calls, the last output)."""
    out = None
    for _ in range(max(warmup, 0)):
        out = fn(*args, **kwargs)
    _fence(out)
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn(*args, **kwargs)
    _fence(out)
    return (time.perf_counter() - t0) / repeats, out
