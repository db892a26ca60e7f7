"""A run driven past its look for a card, on the CPU at a small size, with
the timed path broken underneath: `correct` has to come out false for each
fault the cell can have, and true for the sound program. The limits are
the cells' own (``portbench/limits``)."""
import pytest
import torch

from portbench import harness
from portbench.tests import tiny

SAMPLE = ("kth-sample-traj100", tiny.TRAFFIC["sample"])
TRAIN = ("kth-train-b24", tiny.TRAFFIC["train"])


def run_cell(cell, seed=2 ** 31 + 11):
    name, traffic = cell
    run = harness.make_run(name, seed, 0.5, False, "cpu", config=tiny.config(name),
                           traffic=traffic)
    return harness.execute(run)


@pytest.mark.parametrize("cell", [SAMPLE, TRAIN], ids=["sample", "train"])
def test_sound_program_is_correct(cell):
    result = run_cell(cell)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


def test_sampler_answer_altered(monkeypatch):
    from extdm_tpu_torch.models.dm.diffusion import GaussianDiffusion

    sample = GaussianDiffusion.sample
    monkeypatch.setattr(GaussianDiffusion, "sample",
                        lambda self, *a, **k: sample(self, *a, **k) + 0.1)
    assert not run_cell(SAMPLE)["correct"]


def test_sampler_steps_return_their_state(monkeypatch):
    from extdm_tpu_torch.models.dm.diffusion import GaussianDiffusion

    def unchanged(self, denoise_fn, generator, x_cond, pred_frames, cond_fea=None,
                  init_noise=None, **kw):
        return init_noise.to(x_cond.device, torch.float32)
    monkeypatch.setattr(GaussianDiffusion, "sample", unchanged)
    assert not run_cell(SAMPLE)["correct"]


def test_train_step_returns_its_state(monkeypatch):
    from extdm_tpu_torch.train.lr_schedule import ScheduledOptimizer

    monkeypatch.setattr(ScheduledOptimizer, "step", lambda self, finite=None: True)
    assert not run_cell(TRAIN)["correct"]


def test_train_step_leaves_out_half_the_batch(monkeypatch):
    from extdm_tpu_torch.train.dm_trainer import DMTrainer

    step = DMTrainer.train_step

    def half(self, generator, video, t=None, noise=None):
        h = video.shape[0] // 2
        return step(self, generator, video[:h], t=t[:h], noise=noise[:h])
    monkeypatch.setattr(DMTrainer, "train_step", half)
    assert not run_cell(TRAIN)["correct"]


def test_train_window_step_returns_its_state(monkeypatch):
    """Only the window's steps are broken: the start passes, the timed step fails."""
    from extdm_tpu_torch.train.lr_schedule import ScheduledOptimizer

    from portbench.traffic import train

    step = ScheduledOptimizer.step
    monkeypatch.setattr(ScheduledOptimizer, "step", lambda self, finite=None: (
        True if self.count >= train.CHECKED else step(self, finite)))
    checks = run_cell(TRAIN)["checks"]
    assert checks["update_median_gap"]["value"] <= checks["update_median_gap"]["limit"]
    assert checks["window_update_median_gap"]["value"] > checks["window_update_median_gap"]["limit"]


def test_train_window_step_leaves_out_half_the_batch(monkeypatch):
    from extdm_tpu_torch.train.dm_trainer import DMTrainer

    step = DMTrainer.train_step

    def half_in_the_window(self, generator, video, t=None, noise=None):
        if self.optimizer.count < 3:
            return step(self, generator, video, t=t, noise=noise)
        h = video.shape[0] // 2
        return step(self, generator, video[:h], t=t[:h], noise=noise[:h])
    monkeypatch.setattr(DMTrainer, "train_step", half_in_the_window)
    assert not run_cell(TRAIN)["correct"]
