"""The readers of the program's own spans (``portbench/port_spans.py``):
nothing where no span ran, the right value per unit where spans ran under
a profiler, and a traced run of each cell at the tiny size on the CPU."""
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from extdm_tpu_torch.utils import profiler
from extdm_tpu_torch.utils.profiler import span
from portbench import harness
from portbench.tests import tiny

READERS = {  # reader -> (span or prefix, field, scale)
    "unet_host_ms.sample": ("unet.forward", "total_s", 1e3),
    "launch_host_ms.sample": ("launch.", "total_s", 1e3),
    "schedule_copies.sample": ("schedule_copy", "calls", 1),
    "forward_host_ms.train": ("train.forward", "total_s", 1e3),
    "backward_host_ms.train": ("train.backward", "total_s", 1e3),
    "optimizer_host_ms.train": ("train.optimizer", "total_s", 1e3),
    "launch_host_ms.train": ("launch.", "total_s", 1e3),
    "schedule_copies.train": ("schedule_copy", "calls", 1),
}


def reader(name):
    return harness.load_module(harness.PKG / "metrics" / f"{name}.py",
                               f"portbench_metric_{name.replace('.', '_')}").read


@pytest.fixture(autouse=True)
def fresh_totals():
    profiler.reset()
    yield
    profiler.reset()


def test_every_reader_is_in_the_benchmark():
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    listed = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        assert listed[name]["source"] == "host_clock" and listed[name]["workloads"], name


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_reads_nothing_where_no_span_ran(name):
    assert reader(name)({"units": 3}) is None


def test_readers_give_the_spans_per_unit():
    with profile(activities=[ProfilerActivity.CPU]):
        for step in range(2):
            with span("train.step"):
                for phase in ("train.forward", "train.backward", "train.optimizer"):
                    with span(phase):
                        with span("schedule_copy"):
                            pass
                with span("unet.forward"):
                    for entry in ("launch.stw_layer_wgmma", "launch.resnet_block_wgmma"):
                        with span(entry):
                            pass
    got = profiler.snapshot()
    for name, (key, field, scale) in READERS.items():
        want = scale * sum(v[field] for k, v in got.items()
                           if (k.startswith(key) if key.endswith(".") else k == key)) / 4
        assert reader(name)({"units": 4}) == pytest.approx(want), name
    assert reader("schedule_copies.train")({"units": 2}) == 3.0
    assert reader("schedule_copies.train")({"units": 0}) is None


@pytest.mark.parametrize("cell", [w["name"] for w in tiny.benchmark()["workloads"]])
def test_a_traced_run_reads_the_programs_spans(cell, monkeypatch):
    """Host times on the CPU are only the readers' plumbing, and the CPU
    runs the kernels' plain versions, which launch nothing; the copy count
    is the program's: two a DDIM step, four a train step."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    run = harness.make_run(cell, 2 ** 31 + 7, 1e-3, True, "cpu", config=tiny.config(cell),
                           traffic=tiny.traffic(cell))
    result = harness.execute(run)
    kind = run.traffic["kind"]
    wanted = {m["name"] for m in harness.cell_metrics(run.benchmark, cell, True)
              if m["name"] in READERS}
    assert len(wanted) == (5 if kind == "train" else 3)
    assert {n for n in result["metrics"] if n in READERS} == wanted - {f"launch_host_ms.{kind}"}
    copies = 2 * tiny.MODEL["sampling_timesteps"] if kind == "sample" else 4
    assert result["metrics"][f"schedule_copies.{kind}"]["value"] == copies
