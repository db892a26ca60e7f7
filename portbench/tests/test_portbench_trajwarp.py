"""The plain reference's trajwarp family (``reference/trajwarp.py``) against
the program's plain path on the CPU at a small size (``tiny.TRAJ_MODEL``:
16 px frames, 8 px latents, 4 px features, window (2, 4, 4), adaptors from
level 1), and a run of the KTH sampling cell driven with that model: its
check, a fault planted in the warp, its control and the ``trajwarp`` span.
Tolerances are ``test_portbench_reference``'s, for the same reasons."""
from collections import Counter

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import calibrate, harness, trace
from portbench.cost import kernels
from portbench.reference.pipeline import Reference
from portbench.tests import tiny
from portbench.tests.test_portbench_reference import (SAMPLE_TOL, assert_gradients_match,
                                                      assert_sampler_matches, build_sides,
                                                      program_keys, rel)

CELL = "kth-sample-traj100"


@pytest.fixture(scope="module")
def sides():
    return build_sides(tiny.TRAJ_MODEL)


def test_state_dict_keys_are_the_programs(sides):
    ref, fd = sides
    assert fd.unet.traj and set(ref.state_dict()) == program_keys(fd)


def test_trajwarp_matches_program(sides):
    ref, fd = sides
    g = torch.Generator().manual_seed(11)
    xp = torch.randn(3, 3, 8, 8, 16, generator=g)
    f = torch.randn(3, 5, 4, 4, 16, generator=g)
    with torch.no_grad():
        want = ref.unet.init_traj(xp, f)
        got = fd.unet.init_traj(xp, f)
    assert want.shape == f.shape and rel(got, want) < SAMPLE_TOL
    assert torch.equal(want[:, :2], f[:, :2])  # the cond frames' features pass unchanged


def test_sampler_call_matches_program(sides):
    assert_sampler_matches(*sides)


def test_loss_and_gradients_match_program(sides):
    assert_gradients_match(*sides)


def test_trajwarp_cost_counts_the_references_products():
    ref = Reference(tiny.TRAJ_MODEL).unet.init_traj
    xp, f = torch.randn(2, 3, 8, 8, 16), torch.randn(2, 5, 4, 4, 16)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        ref(xp, f)
    assert kernels.trajwarp_cost(xp, f, heads=ref.heads)[1] == counter.get_total_flops()


def test_unknown_conditioning_raises():
    with pytest.raises(ValueError, match="'none'"):
        Reference(dict(tiny.MODEL, conditioning="none"))


class RecordingSpans(trace.Spans):
    """The harness's spans, counting each span opened."""
    made = []

    def __init__(self, marked: bool):
        super().__init__(marked)
        self.opened = Counter()
        RecordingSpans.made.append(self)

    def _spanned(self, name, fn, args, kwargs):
        self.opened[name] += 1
        return super()._spanned(name, fn, args, kwargs)


@pytest.mark.parametrize("family", ["adaptor", "trajwarp"])
def test_traced_run_spans_the_warp_of_the_trajwarp_family(family, monkeypatch):
    """One ``trajwarp`` op span a DDIM step, each with its least time, in the
    trajwarp family; none in the adaptor family."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(trace, "Spans", RecordingSpans)
    run = harness.make_run(CELL, 2 ** 31 + 13, 1e-3, True, "cpu",
                           config=tiny.config(family=family), traffic=tiny.traffic(CELL))
    result = harness.execute(run)
    spans = RecordingSpans.made[-1]
    assert result["correct"], result["checks"]
    if family == "trajwarp":
        steps = result["attempted"] * tiny.TRAJ_MODEL["sampling_timesteps"]
        assert steps > 0 and spans.opened["op.trajwarp"] == steps
        assert spans.bounds["trajwarp"] > 0
    else:
        assert "op.trajwarp" not in spans.opened and "trajwarp" not in spans.bounds


@pytest.mark.parametrize("warp_left_out", [False, True], ids=["sound", "warp_left_out"])
def test_run_is_correct_only_with_the_warp(warp_left_out, monkeypatch):
    """A run of the cell with the tiny trajwarp model: correct, and not
    correct where the program's ``TrajWarp`` returns the features unwarped."""
    if warp_left_out:
        from extdm_tpu_torch.models.dm.adaptor import TrajWarp

        monkeypatch.setattr(TrajWarp, "forward", lambda self, xp, f, shard=None: f.to(xp.dtype))
    run = harness.make_run(CELL, 2 ** 31 + 11, 0.5, False, "cpu",
                           config=tiny.config(family="trajwarp"), traffic=tiny.traffic(CELL))
    result = harness.execute(run)
    assert result["correct"] is not warp_left_out, result["checks"]


def test_control_fails_where_the_program_passes(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    for seed in (2 ** 31 + 21, 2 ** 32 + 5, 3):
        run = harness.make_run(CELL, seed, 0.0, False, "cpu",
                               config=tiny.config(family="trajwarp"), traffic=tiny.traffic(CELL))
        line = calibrate.sample_seed(harness.driver(run), run, {}, control=True)
        assert all(line["program"][k] <= v for k, v in run.limits.items()), line
        assert any(line["control_fp8"][k] > v for k, v in run.limits.items()), line
