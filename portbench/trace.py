"""Spans that the benchmark opens around calls into the program, and what a
``torch.profiler`` trace of the measured window says.

``Spans`` wraps methods of the objects a driver built (``layer``: a span
named after the layer) and the program's kernel entry points (``op``: a
span per call, and the call's least time on the card from the frozen cost
functions of ``portbench/cost/kernels.py``). Each span is a
``record_function`` range, for the trace's host timeline, and, on the
card, a marker kernel (``torch.cuda._sleep(0)``, an empty spin) launched
on the current stream before and after the call. The markers run in the
order of their launches, so the trace's markers, paired with the spans'
log of them, bound each call's stretch of the device timeline; the call's
device time is the union of the trace's device records inside that
stretch, with no host time in it. (The profiler cannot attribute the
program's own kernels to a host event: they are launched through a
statically linked CUDA runtime, whose launches the trace does not record.)
``summarize`` reduces the trace to the numbers the per-layer readers take.
"""
from __future__ import annotations

import bisect
import functools
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

from portbench.cost.kernels import bound_seconds

SPAN = "pb."
MARK = "spin_kernel"  # the device kernel of torch.cuda._sleep
TOP = 10


class Spans:
    def __init__(self, marked: bool):
        self.marked = marked  # marker kernels around each call
        self.bounds: Dict[str, float] = defaultdict(float)  # op kind -> least seconds in all
        self.marks: List[Tuple[str, bool]] = []  # (span name, opens) of each marker launched
        self._undo: List[tuple] = []

    def _mark(self, name: str, opens: bool) -> None:
        if self.marked:
            torch.cuda._sleep(0)
            self.marks.append((name, opens))

    def _spanned(self, name: str, fn, args, kwargs):
        with torch.profiler.record_function(SPAN + name):
            self._mark(name, True)
            out = fn(*args, **kwargs)
            self._mark(name, False)
        return out

    def _install(self, owner, attr: str, wrapped) -> None:
        self._undo.append((owner, attr, owner.__dict__.get(attr, _ABSENT)))
        object.__setattr__(owner, attr, wrapped)

    def layer(self, owner, attr: str, name: str) -> None:
        """Open the span ``pb.layer.<name>`` around every call of owner.attr."""
        fn = getattr(owner, attr)

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return self._spanned(f"layer.{name}", fn, args, kwargs)
        self._install(owner, attr, wrapped)

    def op(self, module, attr: str, kind: str, cost: Callable) -> None:
        """Open ``pb.op.<kind>`` around each call of the entry point
        module.attr and add its least time; an entry the program no longer
        has is left out."""
        fn = getattr(module, attr, None)
        if fn is None:
            return

        @functools.wraps(fn)  # with its attributes (the program counts launches on them)
        def wrapped(*args, **kwargs):
            self.bounds[kind] += bound_seconds(*cost(*args, **kwargs))
            return self._spanned(f"op.{kind}", fn, args, kwargs)
        self._install(module, attr, wrapped)

    def reset(self) -> None:
        self.bounds.clear()
        self.marks.clear()

    def restore(self) -> None:
        for owner, attr, old in reversed(self._undo):
            if old is _ABSENT:
                object.__delattr__(owner, attr)
            else:
                object.__setattr__(owner, attr, old)
        self._undo.clear()


_ABSENT = object()


def _union(intervals) -> List[tuple]:
    merged: List[list] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [tuple(m) for m in merged]


class _Event:
    __slots__ = ("name", "start", "end")

    def __init__(self, name: str, start: float, end: float):
        self.name, self.start, self.end = name, start, end


def _raw_events(prof):
    """(device, host) events of the trace, times in microseconds, read from
    the profiler's raw results: building its event tree takes minutes on a
    window of a few hundred thousand events. A device record that bears a
    host event's name is the device extent of an annotated range (a span,
    an optimizer step), not work: it is left out."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        length = e.duration_ns()
        if length > 0:
            ev = _Event(e.name(), e.start_ns() / 1e3, (e.start_ns() + length) / 1e3)
            (device if e.device_type() == DeviceType.CUDA else host).append(ev)
    ranges = {e.name for e in host}
    return [e for e in device if e.name not in ranges], host


def span_seconds(device: List[_Event], markers: List[_Event],
                 marks: List[Tuple[str, bool]]) -> Optional[Dict[str, list]]:
    """span name -> [device seconds, calls]: for each call, the union of the
    `device` records that start between the end of its opening marker and
    the start of its closing one. None where the trace's markers do not
    pair with the spans' log of them (a lost record, or a marker on another
    stream)."""
    if len(markers) != len(marks):
        return None
    device = sorted(device, key=lambda e: e.start)
    starts = [e.start for e in device]
    out: Dict[str, list] = defaultdict(lambda: [0.0, 0])
    opened: List[tuple] = []
    for (name, opens), m in zip(marks, sorted(markers, key=lambda e: e.start)):
        if opens:
            opened.append((name, m.end))
            continue
        if not opened or opened[-1][0] != name:
            return None
        _, a = opened.pop()
        b, busy, edge = m.start, 0.0, a
        for e in device[bisect.bisect_left(starts, a):bisect.bisect_left(starts, b)]:
            lo, hi = max(e.start, edge), min(e.end, b)
            if hi > lo:
                busy += hi - lo
            edge = max(edge, hi)
        out[name][0] += busy / 1e6
        out[name][1] += 1
    return dict(out) if not opened else None


def summarize(prof, marks: List[Tuple[str, bool]]) -> dict:
    """busy_s (the union of device intervals: kernels, copies, sets; the
    spans' markers left out), each span's device time (``spans``), the
    device ops that took most time and the longest idle gaps by the host's
    innermost span or op at the gap's start (``breakdown``)."""
    records, cpu = _raw_events(prof)
    markers = [e for e in records if MARK in e.name]
    device = [e for e in records if MARK not in e.name]
    spans = span_seconds(device, markers, marks)
    busy = _union((e.start, e.end) for e in device)
    by_name: Dict[str, float] = defaultdict(float)
    for e in device:
        by_name[e.name] += (e.end - e.start) / 1e6
    window = [e for e in cpu if e.name == f"{SPAN}window"]
    start = window[0].start if window else (busy[0][0] if busy else 0.0)
    gaps = []
    edge = start
    for a, b in busy:
        if a > edge:
            gaps.append((edge, a - edge))
        edge = max(edge, b)
    cpu.sort(key=lambda e: e.start)
    starts = [e.start for e in cpu]
    outer = [e for e in cpu if e.name.startswith(SPAN) and not e.name.startswith(f"{SPAN}op.")]
    idle: Dict[str, float] = defaultdict(float)
    for at, length in gaps:
        idle[_host_label(cpu, starts, outer, at)] += length / 1e6
    top = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:TOP]  # noqa
    return {"busy_s": sum(b - a for a, b in busy) / 1e6, "spans": spans or {},
            "marks_found": len(markers),
            "breakdown": {"device_ops": top(by_name), "idle_gaps": top(idle)}}


def _host_label(cpu, starts, outer, at: float, scan: int = 400) -> str:
    """The innermost benchmark span and the innermost op the host was in at
    `at`: among the `scan` events that started last before it, else the
    innermost of the `outer` (layer and window) spans."""
    i = bisect.bisect_right(starts, at)
    span = op = None
    for e in reversed(cpu[max(0, i - scan):i]):
        if e.end < at:
            continue
        if e.name.startswith(SPAN):
            span = span or e.name[len(SPAN):]
        else:
            op = op or e.name
        if span and op:
            break
    if span is None:  # a long span starts far before its inner ops
        for e in reversed(outer):
            if e.start <= at <= e.end:
                span = e.name[len(SPAN):]
                break
    return f"{span or '-'} / {op or '-'}"
