"""The port's jobs at world 2 and across world sizes, and the build lock,
on the CPU: ``train_dm --shard_map`` and ``train_ae --shard_map`` at world
2 (rank 0 alone logs and checkpoints; both ranks end with the same state),
``valid_dm --mesh_data 2`` (and ``--mesh_model 2`` refused in a world of 1), a checkpoint
written at world 2 resumed at world 1 and the reverse, ``train_dm`` at
world 1 bit for bit the same with and without ``--shard_map``; and
``_build.build_all`` called by 2 ranks at once compiling each source once.

The ranks are spawned processes of a 2-rank gloo group
(``torch_parallel_ranks.jobs``, torchrun's variables, a file store per
run); the configuration is tests/test_torch_jobs.py's tiny one.
"""
import os
import sys
import textwrap

import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from extdm_tpu_torch import config
from extdm_tpu_torch.train import checkpoint, train_dm
from test_torch_jobs import TINY_ARCH, loss_records, records, tiny_yaml

WORLD = 2


def test_build_lock_builds_each_source_once(tmp_path):
    """Two ranks call build_all at once: one compiles each source, the
    other waits for it and loads; a fake nvcc records its calls."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a", "b"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    calls = tmp_path / "calls.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import sys, time
        out, src = sys.argv[sys.argv.index("-o") + 1], sys.argv[-1]
        time.sleep(0.5)
        open({str(calls)!r}, "a").write(src + "\\n")
        open(out, "w").write("built")
        """))
    nvcc.chmod(0o755)
    ranks.spawn(ranks.build_once, WORLD, str(csrc), str(tmp_path / "build"), str(nvcc),
                limit_s=120)
    assert sorted(calls.read_text().split()) == sorted(str(csrc / f"{n}.cu") for n in "ab")
    (out_dir,) = [p for p in (tmp_path / "build").iterdir() if p.is_dir()]
    assert sorted(p.name for p in out_dir.iterdir()) == ["liba.so", "libb.so"]


@pytest.fixture(scope="module")
def job_runs(tmp_path_factory):
    """The DM job at world 1 with and without --shard_map (2 steps each),
    then one spawn of 2 ranks: train_dm --shard_map for 2 steps, its resume
    of the world-1 checkpoint for 1 step, train_ae --shard_map for 2 steps
    and valid_dm --mesh_data 2 on the world-2 checkpoint."""
    tmp = tmp_path_factory.mktemp("jobs")
    cfg_path, _ = tiny_yaml(tmp)
    common = ["--config", cfg_path, "--device", "cpu", "--synthetic_videos", "4",
              "--batch_size", "2", "--valid_every", "0"]
    dm = common + ["--arch", "tiny"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(config.ARCH_PRESETS, "tiny", TINY_ARCH)
        for name, extra in (("w1", []), ("w1_shard_map", ["--shard_map"])):
            assert train_dm.main(dm + ["--max_steps", "2", "--log_dir", str(tmp / name)]
                                 + extra) == 0
    w1_ckpt = str(tmp / "w1" / "flowdiff.ckpt")
    w2_ckpt = str(tmp / "w2" / "flowdiff.ckpt")
    runs = [("train_dm", dm + ["--shard_map", "--max_steps", "2", "--log_dir", str(tmp / "w2")]),
            ("train_dm", dm + ["--shard_map", "--max_steps", "3", "--log_dir",
                               str(tmp / "w1_to_w2"), "--checkpoint", w1_ckpt, "--set_start"]),
            ("train_ae", common + ["--shard_map", "--max_steps", "2", "--log_dir",
                                   str(tmp / "ae_w2")]),
            ("valid_dm", ["--config", cfg_path, "--arch", "tiny", "--device", "cpu",
                          "--synthetic_videos", "2", "--num_sample_video", "2", "--batch_size",
                          "2", "--metrics", "psnr,ssim", "--checkpoint", w2_ckpt,
                          "--mesh_data", "2", "--log_dir", str(tmp / "valid_w2")])]
    ranks.spawn(ranks.jobs, WORLD, str(tmp), TINY_ARCH, runs, str(tmp))
    return tmp, dm


def test_train_dm_shard_map_at_world_2(job_runs):
    tmp, _ = job_runs
    log = str(tmp / "w2")
    recs = loss_records(log, "loss")
    assert [r["step"] for r in recs] == [0, 1] and all(np.isfinite(r["loss"]) for r in recs)
    assert "step 1: loss=" in open(os.path.join(log, "train.log")).read()
    ckpt = checkpoint.load_checkpoint(os.path.join(log, "flowdiff.ckpt"))
    assert (ckpt["step"], ckpt["example"], ckpt["optimizer"]["count"]) == (2, 4, 2)
    assert sorted(os.listdir(os.path.join(log, "imgshots"))) == ["B0002_S000001.png"]
    ranks_state = [torch.load(tmp / f"0.rank{r}.pt") for r in range(WORLD)]
    assert all(torch.equal(ranks_state[0][k], ranks_state[1][k]) for k in ranks_state[0])
    for k, v in ranks_state[0].items():
        assert torch.equal(ckpt["diffusion"][f"denoise_fn.{k}"], v), k


def test_train_ae_shard_map_at_world_2(job_runs):
    tmp, _ = job_runs
    log = str(tmp / "ae_w2")
    recs = loss_records(log, "loss_total")
    assert [r["step"] for r in recs] == [0, 1]
    assert all(np.isfinite(r["loss_total"]) for r in recs)
    ckpt = checkpoint.load_checkpoint(os.path.join(log, "RegionMM.ckpt"))
    assert (ckpt["step"], ckpt["example"], ckpt["optimizer"]["count"]) == (2, 4, 2)
    a, b = (torch.load(tmp / f"2.rank{r}.pt") for r in range(WORLD))
    assert all(torch.equal(a[k], b[k]) for k in a)  # running statistics too: SyncBN


def test_valid_dm_mesh_data_2_runs_and_mesh_model_raises(job_runs):
    tmp, _ = job_runs
    lines = open(tmp / "valid_w2" / "metrics.txt").read().splitlines()
    assert [line.split(":")[0] for line in lines] == [
        "psnr2 (best-of-2)", "ssim2 (best-of-2)", "sampling_frames_per_sec"]
    from extdm_tpu_torch.eval import valid_dm

    # --mesh_model runs since the spatial sampler (test_torch_spatial_sampler.py);
    # a process alone is no (1 x 2) mesh
    with pytest.raises(ValueError, match=r"--mesh_data 1 x --mesh_model 2 in a launch of 1"):
        valid_dm.main(["--config", "unused.yaml", "--device", "cpu", "--mesh_model", "2"])


def test_checkpoint_crosses_world_sizes(job_runs):
    """World 2's checkpoint resumes at world 1, world 1's at world 2: each
    run starts at the step after the checkpoint's, from its weights and
    Adam moments (rank 1 reads them as rank 0 does: both ranks end equal)."""
    tmp, dm = job_runs
    w2 = checkpoint.load_checkpoint(str(tmp / "w2" / "flowdiff.ckpt"))
    seen = {}
    real = train_dm.train_loop

    def capture(trainer, *a, **k):
        seen["start"] = {n: p.detach().clone() for n, p in trainer.fd.unet.named_parameters()}
        seen["count"] = trainer.optimizer.count
        return real(trainer, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(config.ARCH_PRESETS, "tiny", TINY_ARCH)
        mp.setattr(train_dm, "train_loop", capture)
        assert train_dm.main(dm + ["--max_steps", "3", "--log_dir", str(tmp / "w2_to_w1"),
                                   "--checkpoint", str(tmp / "w2" / "flowdiff.ckpt"),
                                   "--set_start"]) == 0
    assert seen["count"] == 2
    for n, p in seen["start"].items():
        assert torch.equal(p, w2["diffusion"][f"denoise_fn.{n}"]), n
    assert [r["step"] for r in loss_records(str(tmp / "w2_to_w1"), "loss")] == [2]

    log = str(tmp / "w1_to_w2")
    assert "at step 2" in open(os.path.join(log, "train.log")).read()
    assert [r["step"] for r in loss_records(log, "loss")] == [2]
    ckpt = checkpoint.load_checkpoint(os.path.join(log, "flowdiff.ckpt"))
    assert (ckpt["step"], ckpt["example"], ckpt["optimizer"]["count"]) == (3, 6, 3)
    a, b = (torch.load(tmp / f"1.rank{r}.pt") for r in range(WORLD))
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_train_dm_at_world_1_repeats_the_single_process_run(job_runs):
    """--shard_map at world 1 changes nothing: checkpoint and metrics
    (losses) equal the run without it bit for bit."""
    tmp, _ = job_runs
    a, b = (checkpoint.load_checkpoint(str(tmp / n / "flowdiff.ckpt"))
            for n in ("w1", "w1_shard_map"))
    assert a["diffusion"].keys() == b["diffusion"].keys()
    assert all(torch.equal(a["diffusion"][k], b["diffusion"][k]) for k in a["diffusion"])
    for k, v in a["optimizer"]["state"].items():
        assert all(torch.equal(v[s], b["optimizer"]["state"][k][s]) for s in v)
    la, lb = (loss_records(str(tmp / n), "loss") for n in ("w1", "w1_shard_map"))
    assert [r["loss"] for r in la] == [r["loss"] for r in lb]
    assert len(records(str(tmp / "w1"))) == len(records(str(tmp / "w1_shard_map")))


def test_a_rank_outside_the_data_group_waits_for_the_run(tmp_path):
    """3 ranks, batch 2: ranks 0 and 1 train (make_data_group's rule),
    rank 2 joins no collective and waits at the end; the run finishes."""
    cfg_path, _ = tiny_yaml(tmp_path)
    log = str(tmp_path / "w3")
    argv = ["--config", cfg_path, "--device", "cpu", "--synthetic_videos", "4", "--arch", "tiny",
            "--batch_size", "2", "--valid_every", "0", "--max_steps", "1", "--log_dir", log]
    ranks.spawn(ranks.jobs, WORLD + 1, str(tmp_path), TINY_ARCH, [("train_dm", argv)],
                str(tmp_path))
    ckpt = checkpoint.load_checkpoint(os.path.join(log, "flowdiff.ckpt"))
    assert (ckpt["step"], ckpt["example"]) == (1, 2)
    a, b = (torch.load(tmp_path / f"0.rank{r}.pt") for r in range(WORLD))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not (tmp_path / f"0.rank{WORLD}.pt").exists()  # it built no trainer
