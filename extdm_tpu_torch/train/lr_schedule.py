"""Learning-rate schedules (port of extdm_tpu/train/lr_schedule.py)."""
from __future__ import annotations

from typing import Callable, Sequence


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
