"""Run logs (port of extdm_tpu/utils/logger.py): the stdout tee, JSONL
metric records and the step timer. In a data-parallel job rank 0 writes
the logs; the other ranks get a ``MetricLogger(None)``, which records
nothing (and print to os.devnull)."""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Optional

import torch


class Logger:
    """Tee stdout to a log file, line-buffered so that a killed run keeps
    every line it printed."""

    def __init__(self, filename: str, mode: str = "a"):
        self.terminal = sys.stdout
        os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
        self.log = open(filename, mode, buffering=1)

    def write(self, message):
        self.terminal.write(message)
        self.log.write(message)

    def flush(self):
        self.terminal.flush()
        self.log.flush()

    def close(self):
        self.log.close()


class MetricLogger:
    """Append-only JSONL records {"step", "time", ...}; ``path=None``
    records nothing."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self._f = None
        if path is not None:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a", buffering=1)

    def log(self, step: int, **metrics: Any) -> None:
        if self._f is None:
            return
        rec: Dict[str, Any] = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._f.write(json.dumps(rec) + "\n")

    def close(self):
        if self._f is not None:
            self._f.close()


class AverageMeter:
    """Running average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class StepTimer:
    """Host-side step timing. ``mark_data`` after a batch arrives,
    ``mark_step(result)`` after the step (a CUDA tensor result is fenced
    with ``torch.cuda.synchronize``), ``skip`` after validation, checkpoint
    or shot work so that it lands in no data_time sample, ``reset`` to start
    a new window of averages."""

    def __init__(self):
        self.batch_time = AverageMeter()
        self.data_time = AverageMeter()
        self._last = time.perf_counter()

    def mark_data(self):
        now = time.perf_counter()
        self.data_time.update(now - self._last)
        return now

    def mark_step(self, result=None):
        if torch.is_tensor(result) and result.is_cuda:
            torch.cuda.synchronize(result.device)
        now = time.perf_counter()
        self.batch_time.update(now - self._last)
        self._last = now

    def skip(self):
        self._last = time.perf_counter()

    def reset(self):
        self.batch_time.reset()
        self.data_time.reset()
        self._last = time.perf_counter()
