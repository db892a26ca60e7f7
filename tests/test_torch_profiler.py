"""The port's spans (``utils/profiler.py``) on the CPU: off without a
profiler, totals and nesting under one, a stack per thread, and the spans
the DDIM loop, the kernel launcher and ``trace`` open."""
import json
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from extdm_tpu_torch import _build
from extdm_tpu_torch.models.dm.diffusion import DiffusionSchedule, GaussianDiffusion
from extdm_tpu_torch.utils import profiler
from extdm_tpu_torch.utils.profiler import span


@pytest.fixture(autouse=True)
def fresh_totals():
    profiler.reset()
    yield
    profiler.reset()


def recording():
    return profile(activities=[ProfilerActivity.CPU])


def test_a_span_without_a_profiler_records_nothing():
    with span("a"):
        with span("b"):
            pass
    span("c")(lambda: None)()
    assert profiler.snapshot() == {}


def test_nested_spans_give_calls_total_self_and_parent():
    @span("inner")
    def inner():
        time.sleep(0.002)

    with recording() as prof:
        with span("outer"):
            time.sleep(0.002)
            inner()
            inner()
    got = profiler.snapshot()
    outer, inn = got["outer"], got["inner"]
    assert (outer["calls"], inn["calls"]) == (1, 2)
    assert (outer["parent"], inn["parent"]) == (None, "outer")
    assert inn["total_s"] >= 0.004 and inn["self_s"] == inn["total_s"]
    assert outer["total_s"] >= 0.006
    assert outer["self_s"] == pytest.approx(outer["total_s"] - inn["total_s"], abs=1e-9)
    names = {e.name for e in prof.events()}
    assert {"extdm.outer", "extdm.inner"} <= names  # ranges on the profiler's timeline


def test_a_span_on_another_thread_nests_under_nothing_of_this_one(monkeypatch):
    # a plain thread does not inherit the profiler's state (autograd's device
    # threads do): take every thread as recording
    monkeypatch.setattr(profiler, "_enabled", lambda: True)
    with span("main"):
        worker = threading.Thread(target=lambda: span("side")(time.sleep)(0.002))
        worker.start()
        worker.join(30)
    assert not worker.is_alive()
    got = profiler.snapshot()
    assert got["side"]["parent"] is None and got["main"]["parent"] is None
    assert got["main"]["self_s"] == got["main"]["total_s"]


def test_ddim_sample_spans_each_step_and_its_schedule_copies():
    diffusion = GaussianDiffusion(DiffusionSchedule.create(100), sampling_timesteps=3)
    x_cond = torch.zeros(1, 1, 2, 2, 3)
    with recording():
        diffusion.sample(lambda x, t, c, f: torch.zeros_like(x), torch.Generator().manual_seed(0),
                         x_cond, 2, None)
    got = profiler.snapshot()
    assert {k: v["calls"] for k, v in got.items()} == {
        "sample.ddim": 1, "ddim.step": 3, "ddim.denoise": 3, "ddim.update": 3,
        "schedule_copy": 6}
    assert got["ddim.step"]["parent"] == "sample.ddim"
    assert got["schedule_copy"]["parent"] == "ddim.update"


def test_launch_opens_a_span_named_after_the_entry(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "_function",
                        lambda source, name: lambda *args: calls.append((source, name)) or 0)
    with recording():
        _build.launch("resnet", "resnet_block_wgmma", 1, 2)
        _build.launch("resnet", "resnet_block_wgmma")
    assert calls == [("resnet", "resnet_block_wgmma")] * 2
    assert profiler.snapshot()["launch.resnet_block_wgmma"]["calls"] == 2


def test_trace_writes_the_blocks_spans(tmp_path):
    with recording():
        with span("before"):
            pass
    with profiler.trace(str(tmp_path / "trace")):
        with span("x"):
            pass
    got = json.loads((tmp_path / "trace" / "spans.json").read_text())
    assert set(got) == {"x"} and got["x"]["calls"] == 1 and got["x"]["parent"] is None
