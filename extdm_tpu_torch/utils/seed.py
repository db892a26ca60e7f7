"""Seeding (port of extdm_tpu/utils/seed.py).

``setup_seed`` seeds the host streams the data pipeline draws from (Python's
``random`` for the augmentation parameters, numpy's global stream) and
returns the job's root ``torch.Generator`` on the job's device. A step's
draws come from ``step_generator(root, step)``: a generator seeded from the
root's seed and the step alone, so a resumed run draws what an
uninterrupted run draws at the same step (JAX's ``fold_in(root, step)``).
"""
from __future__ import annotations

import random

import numpy as np
import torch


def setup_seed(seed: int, device="cpu") -> torch.Generator:
    random.seed(seed)
    np.random.seed(seed)
    return torch.Generator(device=device).manual_seed(seed)


def step_generator(root: torch.Generator, step: int) -> torch.Generator:
    """A generator on root's device for step `step`, a function of (the
    root's seed, step) only."""
    seed = (root.initial_seed() * 1_000_003 + int(step)) % (2 ** 63)
    return torch.Generator(device=root.device).manual_seed(seed)
