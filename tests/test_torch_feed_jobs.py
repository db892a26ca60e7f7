"""The training jobs on the port's process loader and clip cache, the warm-up
schedules, the profiler hooks and the console entry points, on the CPU.

- ``train_dm.main`` and ``train_ae.main`` with ``--loader process`` (two
  forked workers) take two steps on HDF5 shards at the tiny sizes of
  tests/test_torch_jobs.py, once with ``--clip_cache_mb`` (which prefills and
  prints JAX's line) and once without: the same losses, bit for bit.
- ``warmup_cosine`` / ``warmup_linear`` against JAX's at steps 0..total+2
  within 1e-6 of base_lr: JAX computes in float32, whose rounding (~1e-7 of
  base_lr) is a larger part of the small learning rates near a cosine's end.
- ``trace`` runs on the CPU and writes its spans' totals beside the trace;
  the ``extdm-torch-*`` entry points reach the port's ``main``s.
"""
import re
import threading
from pathlib import Path

import numpy as np
import pytest
import yaml

from extdm_tpu.train import lr_schedule as j_lr
from extdm_tpu_torch import cli, config, data
from extdm_tpu_torch.train import lr_schedule, train_ae, train_dm
from extdm_tpu_torch.utils import profiler
from test_torch_jobs import TINY_ARCH, loss_records, tiny_yaml

REPO = Path(__file__).resolve().parents[1]


def bounded(fn, timeout=300):
    """fn() in a thread joined with a timeout: its value, or its exception."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # handed to the test's thread below
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"no result within {timeout} s"
    if "error" in out:
        raise out["error"]
    return out["value"]


@pytest.mark.parametrize("job", ["dm", "ae"])
def test_job_process_loader_repeats_with_and_without_clip_cache(tmp_path, monkeypatch, job):
    monkeypatch.setitem(config.ARCH_PRESETS, "tiny", TINY_ARCH)
    cfg_path, cfg = tiny_yaml(tmp_path)
    for section in ("diffusion_params", "flow_params"):
        cfg[section]["train_params"]["dataloader_workers"] = 2
    Path(cfg_path).write_text(yaml.safe_dump(cfg))
    root = str(tmp_path / "data")
    data.write_moving_shapes_dataset(root, num_train=4, num_valid=2, num_frames=12,
                                     image_size=32, seed=3)
    main, key = (train_dm.main, "loss") if job == "dm" else (train_ae.main, "loss_total")
    extra = ["--arch", "tiny"] if job == "dm" else []
    losses = []
    for i, cache in enumerate((["--clip_cache_mb", "1"], [])):
        log = str(tmp_path / f"run{i}")
        argv = ["--config", cfg_path, "--device", "cpu", "--root_dir", root, "--batch_size", "2",
                "--max_steps", "2", "--valid_every", "0", "--loader", "process", "--log_dir",
                log] + extra + cache
        assert bounded(lambda: main(argv)) == 0
        recs = loss_records(log, key)
        assert [r["step"] for r in recs] == [0, 1]
        losses.append([r[key] for r in recs])
        lines = re.findall(r"clip cache prefilled: (\d+) videos in [\d.]+s",
                           Path(log, "train.log").read_text())
        assert lines == (["4"] if cache else [])
    assert np.isfinite(losses[0]).all() and losses[0] == losses[1]


@pytest.mark.parametrize("kind", ["warmup_cosine", "warmup_linear"])
@pytest.mark.parametrize("warmup,total,min_ratio", [(5, 20, 0.0), (0, 7, 0.1), (3, 3, 0.25)])
def test_warmup_schedules_match_jax(kind, warmup, total, min_ratio):
    got = getattr(lr_schedule, kind)(2e-4, warmup, total, min_ratio)
    want = getattr(j_lr, kind)(2e-4, warmup, total, min_ratio)
    for step in range(total + 3):  # JAX's float32 rounding is relative to base_lr
        np.testing.assert_allclose(got(step), float(want(step)), rtol=0, atol=1e-6 * 2e-4)


def test_device_timer_and_trace_on_cpu(tmp_path):
    import json

    import torch

    x = torch.arange(4.0)
    with profiler.trace(str(tmp_path / "trace")):
        with profiler.span("outer"):
            (x @ x).item()
    assert list((tmp_path / "trace").glob("*.pt.trace.json"))
    spans = json.loads((tmp_path / "trace" / "spans.json").read_text())
    assert spans["outer"]["calls"] == 1 and spans["outer"]["total_s"] > 0


@pytest.mark.parametrize("entry,module", [
    ("train_ae_main", "extdm_tpu_torch.train.train_ae"),
    ("train_dm_main", "extdm_tpu_torch.train.train_dm"),
    ("valid_ae_main", "extdm_tpu_torch.eval.valid_ae"),
    ("valid_dm_main", "extdm_tpu_torch.eval.valid_dm"),
    ("make_dataset_main", "extdm_tpu_torch.data.make_dataset")])
def test_cli_entry_points_reach_port_mains(monkeypatch, entry, module):
    import importlib

    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, "main", lambda argv=None: 7)
    with pytest.raises(SystemExit) as exit_:
        getattr(cli, entry)()
    assert exit_.value.code == 7
    scripts = (REPO / "pyproject.toml").read_text()
    name = "extdm-torch-" + entry[:-len("_main")].replace("_", "-")
    assert f'{name} = "extdm_tpu_torch.cli:{entry}"' in scripts
