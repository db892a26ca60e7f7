"""Learning-rate schedules (port of extdm_tpu/train/lr_schedule.py) and the
scheduled, nan-guarded optimizer wrapper both trainers use."""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch


def multi_step(base_lr: float, milestones: Sequence[int], gamma: float) -> Callable[[int], float]:
    """torch MultiStepLR as a function of the update count: base_lr times
    gamma for every milestone m <= count, the value optax's
    piecewise_constant_schedule({m: gamma}) gives."""
    marks = sorted({int(m) for m in milestones})

    def schedule(count: int) -> float:
        lr = base_lr
        for m in marks:
            if count >= m:
                lr *= gamma
        return lr

    return schedule


def _warmup(base_lr: float, warmup_steps: int, total_steps: int,
            decay: Callable[[float], float]) -> Callable[[int], float]:
    """base_lr times count / warmup_steps below warmup_steps, then times
    decay(progress), progress rising from 0 to 1 over the remaining steps."""
    def schedule(count: int) -> float:
        if count < warmup_steps:
            return base_lr * min(count / max(warmup_steps, 1), 1.0)
        prog = min(max((count - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return base_lr * decay(prog)

    return schedule


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.0) -> Callable[[int], float]:
    """Linear warm-up, then a half cosine from base_lr to min_ratio * base_lr."""
    return _warmup(base_lr, warmup_steps, total_steps,
                   lambda p: min_ratio + (1 - min_ratio) * 0.5 * (1 + math.cos(math.pi * p)))


def warmup_linear(base_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.0) -> Callable[[int], float]:
    """Linear warm-up, then a line from base_lr to min_ratio * base_lr."""
    return _warmup(base_lr, warmup_steps, total_steps, lambda p: 1 - (1 - min_ratio) * p)


class ScheduledOptimizer:
    """A torch optimizer whose learning rate is schedule(update count), as an
    optax transformation built on a schedule.

    With nan_guard > 0 (optax.apply_if_finite): a step whose gradients are
    not all finite is skipped, parameters, moments and update count
    untouched; after nan_guard consecutive skips the next non-finite step
    raises instead of applying its update."""

    def __init__(self, opt: torch.optim.Optimizer, schedule: Callable[[int], float],
                 nan_guard: int = 0):
        self.opt = opt
        self.params = [p for group in opt.param_groups for p in group["params"]]
        self.schedule = schedule
        self.nan_guard = nan_guard
        self.count = 0  # updates applied
        self.notfinite_count = 0  # consecutive skipped steps

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> bool:
        """Apply one update from the parameters' .grad (zeros where a
        parameter has none, as optax sees a zero gradient); returns False
        when the nan guard skipped it."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.nan_guard > 0:
            finite = bool(torch.stack([torch.isfinite(p.grad).all() for p in self.params]).all())
            if not finite:
                self.notfinite_count += 1
                if self.notfinite_count > self.nan_guard:
                    raise FloatingPointError(
                        f"non-finite gradients in {self.notfinite_count} consecutive steps")
                return False
            self.notfinite_count = 0
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.count)
        self.opt.step()
        self.count += 1
        return True

    def state_dict(self) -> dict:
        """The torch optimizer's state dict, with the update count and the
        nan guard's count of consecutive skips beside it."""
        return {**self.opt.state_dict(), "count": self.count,
                "notfinite_count": self.notfinite_count}

    def load_state_dict(self, state: dict) -> None:
        state = dict(state)
        self.count = int(state.pop("count"))
        self.notfinite_count = int(state.pop("notfinite_count"))
        self.opt.load_state_dict(state)
