"""The program's own spans (``extdm_tpu_torch.utils.profiler``): their
totals over the traced window, per unit of work.

The program records a span only while a ``torch.profiler`` session
records, which the harness opens after set-up and closes before the
check, so the totals cover the window alone. A program without spans
(an earlier commit) has no ``snapshot``: its readers read nothing.
"""
from __future__ import annotations

from typing import Optional


def totals() -> dict:
    """name -> {calls, total_s, self_s, parent}, or {} without spans."""
    from extdm_tpu_torch.utils import profiler

    snapshot = getattr(profiler, "snapshot", None)
    return snapshot() if snapshot is not None else {}


def per_unit(trace: dict, name: str, field: str, scale: float = 1.0,
             prefix: bool = False) -> Optional[float]:
    """scale x the sum of `field` over the spans called `name` (or, with
    `prefix`, whose names start with it), per unit of the window; None where
    no such span ran."""
    found = [t[field] for n, t in totals().items()
             if (n.startswith(name) if prefix else n == name)]
    if not found or trace["units"] == 0:
        return None
    return scale * sum(found) / trace["units"]
