"""Tracing of the port's host work (port of extdm_tpu/utils/profiler.py).

- ``span(name)``: a named stretch of the port's host work, as a ``with``
  block or a decorator. Off unless a ``torch.profiler`` session records on
  the calling thread: then it costs one check and records nothing. On, it
  opens ``record_function("extdm." + name)``, a range on the profiler's
  timeline beside the card's records, and adds the call to totals per name:
  ``calls``, host seconds inside it (``total_s``, ``time.perf_counter``),
  those less the spans directly inside it on the same thread (``self_s``),
  and the name of the span around its first call (``parent``, None at the
  top). Each thread keeps its own stack of open spans: autograd runs a CUDA
  backward on its own device thread, which the profiler's state reaches, so
  the backward's spans nest under nothing of the thread that called
  ``backward()``. A span's ``calls`` is its count; there is no other counter.
- ``snapshot()``: the totals, ``{name: {calls, total_s, self_s, parent}}``;
  ``reset()`` clears them.
- ``trace(logdir)``: ``torch.profiler`` around a block (CPU, and CUDA where
  there is a card), written to `logdir` as a TensorBoard trace, with the
  block's span totals beside it as ``spans.json``.

The spans the port opens ("extdm." + the name):

- ``sample`` (each sampler's call: ``make_sampler``, ``make_sharded_sampler``,
  ``make_spatial_sampler``, ``sample_video``), with ``sample.encode`` (the
  LFAE encode of the cond frames), ``sample.cond_cache`` (the conditioning
  term), ``sample.ddim`` (``GaussianDiffusion.sample``) and
  ``sample.decode`` (the predicted latents to flows and frames).
- ``ddim.step``, one a denoising step (DDIM and ancestral), with
  ``ddim.denoise`` (the denoiser's call) and ``ddim.update`` (the x0
  estimate, its threshold and the step's update) inside it.
- ``unet.forward``: ``Unet3D.forward``, the host's cost of issuing the UNet.
- ``train.step`` (``DMTrainer.train_step``), with ``train.forward`` (the
  loss), ``train.backward``, ``train.reduce`` (the data- or tensor-parallel
  reductions, where there is a group or mesh) and ``train.optimizer`` (the
  gradient norm, the nan guard and the scheduled AdamW step).
- ``launch.<entry>``: each call of a hand-written kernel's C entry point
  (``_build.launch``); the entry's name tells the route taken.
- ``schedule_copy``: each copy of a diffusion schedule table from the host
  to the tensor's device (to a card from pinned memory, without a wait).
- ``table_upload``: each build of a table kept on a device per shape (the
  UNet's window and bucket indices, rotary and shift-mask tables): a cache
  miss, so none in a steady loop.
"""
from __future__ import annotations

import contextlib
import functools
import json
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

PREFIX = "extdm."

_enabled = torch._C._autograd._profiler_enabled  # this thread's profiler state
_local = threading.local()
_lock = threading.Lock()
_totals: Dict[str, dict] = {}


class _Frame:
    __slots__ = ("name", "parent", "record", "start", "inner")

    def __init__(self, name: str, parent: Optional[str], record):
        self.name, self.parent, self.record = name, parent, record
        self.inner = 0.0  # seconds of the spans directly inside
        self.start = 0.0


def _stack() -> List[_Frame]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class span:
    """``with span(name):`` or ``@span(name)``: see the module's docstring."""
    __slots__ = ("name", "_frame")

    def __init__(self, name: str):
        self.name = name
        self._frame = None

    def __enter__(self):
        if _enabled():
            record = torch.profiler.record_function(PREFIX + self.name)
            record.__enter__()
            stack = _stack()
            frame = _Frame(self.name, stack[-1].name if stack else None, record)
            stack.append(frame)
            self._frame = frame
            frame.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        frame, self._frame = self._frame, None
        if frame is None:
            return False
        seconds = time.perf_counter() - frame.start
        stack = _stack()
        stack.pop()
        if stack:
            stack[-1].inner += seconds
        frame.record.__exit__(*exc)
        with _lock:
            total = _totals.get(frame.name)
            if total is None:
                total = _totals[frame.name] = dict(calls=0, total_s=0.0, self_s=0.0,
                                                   parent=frame.parent)
            total["calls"] += 1
            total["total_s"] += seconds
            total["self_s"] += seconds - frame.inner
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):  # a span of its own for each call: reentrant, per thread
                return fn(*args, **kwargs)
        return spanned


def snapshot() -> Dict[str, dict]:
    """The spans' totals since the last ``reset()``."""
    with _lock:
        return {name: dict(total) for name, total in _totals.items()}


def reset() -> None:
    with _lock:
        _totals.clear()


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` around the block, its TensorBoard trace and the
    block's span totals (``spans.json``, as ``snapshot()``) in `logdir`."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    reset()
    try:
        with profile(activities=activities,
                     on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
            yield prof
    finally:
        Path(logdir).mkdir(parents=True, exist_ok=True)
        (Path(logdir) / "spans.json").write_text(json.dumps(snapshot(), indent=1,
                                                            sort_keys=True))
