"""Console entry points of the port (``pyproject.toml`` ``[project.scripts]``:
``extdm-torch-train-ae``, ``-train-dm``, ``-valid-ae``, ``-valid-dm``,
``-make-dataset``, ``-analyze-dumps``, ``-video2video``, ``-metrics-demo``
and ``-convert-checkpoint``), each the ``main`` of its module on the
command line's arguments."""
from __future__ import annotations


def train_ae_main():
    from extdm_tpu_torch.train import train_ae

    raise SystemExit(train_ae.main())


def train_dm_main():
    from extdm_tpu_torch.train import train_dm

    raise SystemExit(train_dm.main())


def valid_ae_main():
    from extdm_tpu_torch.eval import valid_ae

    raise SystemExit(valid_ae.main())


def valid_dm_main():
    from extdm_tpu_torch.eval import valid_dm

    raise SystemExit(valid_dm.main())


def make_dataset_main():
    from extdm_tpu_torch.data import make_dataset

    raise SystemExit(make_dataset.main())


def analyze_dumps_main():
    from extdm_tpu_torch.eval import analyze_dumps

    raise SystemExit(analyze_dumps.main())


def video2video_main():
    from extdm_tpu_torch.eval import video2video

    raise SystemExit(video2video.main())


def metrics_demo_main():
    from extdm_tpu_torch.metrics import demo

    raise SystemExit(demo.main())


def convert_checkpoint_main():
    from extdm_tpu_torch import convert_checkpoint

    raise SystemExit(convert_checkpoint.main())
