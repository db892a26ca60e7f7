"""The control, at a size the CPU holds: the reference with its products in
fp8 put in the program's place has to come out not correct under each
cell's limits, where the program (its plain float32 path here) comes out
correct. On the card, at the cells' sizes, ``portbench/calibrate.py``
reads the same numbers (PERF.md gives them)."""
import pytest
import torch

from portbench import calibrate, harness
from portbench.tests import tiny

CELLS = {w["name"]: tiny.traffic(w["name"]) for w in tiny.benchmark()["workloads"]}


def fails(numbers: dict, limits: dict) -> bool:
    return any(numbers[k] > v for k, v in limits.items())


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_fails_where_the_program_passes(cell, monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    traffic = CELLS[cell]
    for seed in (2 ** 31 + 21, 2 ** 32 + 5, 3):
        run = harness.make_run(cell, seed, 0.0, False, "cpu", config=tiny.config(cell),
                               traffic=traffic)
        read = calibrate.train_seed if traffic["kind"] == "train" else calibrate.sample_seed
        line = read(harness.driver(run), run, {}, control=True)
        assert not fails(line["program"], run.limits), line
        assert fails(line["control_fp8"], run.limits), line
