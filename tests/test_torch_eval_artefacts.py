"""The evaluation artefacts and tools of the port end to end on the CPU, at
the tiny config of tests/test_torch_jobs.py (32 px, tc = tp = 2, 4
predicted frames: 2 autoregressive rounds), against the JAX package.

- ``valid_dm.main --dump_arrays --dump_flow`` (2 synthetic videos x 2
  trajectories, the LFAE a JAX variable tree converted by
  ``convert_checkpoint --kind lfae``): every file of scripts/valid_dm.py;
  origin.npy the loader's videos exactly, result.npy trajectory 0 of the
  samples, result_flows.npy trajectory 0's grids of each sampler call
  (recorded), both rounds joined, exactly; origin_flows.npy against JAX's
  ``encode_video`` on the same weights within 2e-4; flow_vis the first
  batch's last call's tc + tp grids and confidences of row 0, exactly.
- ``--mesh_data 2`` (2 gloo ranks spawned) writes the files of a world of
  one whose sampler draws each half of the rows from that rank's generator
  (what the ranks draw): the same names, arrays within 1e-5, the same
  metric lines.
- ``analyze_dumps.main`` on those dumps against scripts/analyze_dumps.py's
  ``main`` in-process: metrics.json's PSNR and SSIM within 1e-6, the CSV
  equal, every rendered gif's frames equal (the writers recorded).
- ``video2video.main``: its hybrid videos built as scripts/video2video.py
  builds them, its transfer and flows against JAX's ``encode_video(...,
  with_decode=True)`` on them within 2e-4, its files.
- ``convert_checkpoint --kind dm`` of a JAX DM train state, then
  ``train_dm --checkpoint --set_start`` resumes at the JAX run's step and
  takes one; scripts/draw_curves.py plots that job's metrics.jsonl.
"""
import importlib.util
import json
import os
import sys
from pathlib import Path

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import torch_parallel_ranks as ranks
from extdm_tpu.models.dm.flow_diffusion import LFAE as JLFAE
from extdm_tpu.models.dm.flow_diffusion import FlowDiffusion as JFlowDiffusion
from extdm_tpu.models.dm.flow_diffusion import FlowDiffusionConfig as JConfig
from extdm_tpu.train import checkpoint as jckpt
from extdm_tpu.train import dm_trainer as j_dm_trainer
from extdm_tpu.utils import visualize as jvis
from extdm_tpu_torch import config, convert_checkpoint, data
from extdm_tpu_torch.eval import analyze_dumps, valid_dm, video2video
from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusion
from extdm_tpu_torch.parallel.mesh import rank_generator
from extdm_tpu_torch.train import checkpoint, train_dm
from extdm_tpu_torch.utils import flow_viz, visualize
from test_torch_jobs import TINY_ARCH, loss_records, tiny_yaml
from torch_port_helpers import close, random_variables, tiny_flow_params

REPO = Path(__file__).resolve().parents[1]
TC, TOTAL_PRED, N_VIDEOS, N_TRAJ, SEED = 2, 4, 2, 2, 1234
ARRAYS = ("origin.npy", "result.npy", "origin_flows.npy", "result_flows.npy")


def _load_script(name):
    spec = importlib.util.spec_from_file_location(f"_{name}_cli", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _halves_sampler(make_sampler):
    """FlowDiffusion.make_sampler whose sampler draws each half of the rows
    with rank r's generator, as make_sharded_sampler's 2 ranks draw them."""
    def make(self, decode=True):
        plain = make_sampler(self, decode)

        def sampler(gen, cond, init_noise=None):
            n = cond.shape[0] // 2
            outs = [plain(rank_generator(gen, r), cond[r * n:(r + 1) * n]) for r in range(2)]
            return {k: None if outs[0][k] is None else torch.cat([o[k] for o in outs])
                    for k in outs[0]}
        return sampler
    return make


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The tiny yaml (valid: 4 predicted frames), the JAX LFAE variables and
    their .pth, valid_dm at world 1 (the dict it wrote its artefacts from
    kept), at world 1 with the ranks' draws, and at world 2 (--mesh_data 2)."""
    tmp = tmp_path_factory.mktemp("artefacts")
    cfg_path, cfg = tiny_yaml(tmp)
    cfg["dataset_params"]["valid_params"]["pred_frames"] = TOTAL_PRED
    open(cfg_path, "w").write(yaml.safe_dump(cfg))
    jl = JLFAE(flow_params=tiny_flow_params())
    shapes = jax.eval_shape(lambda v: jl.init(jax.random.PRNGKey(0), v, TC),
                            jnp.zeros((1, TC + TOTAL_PRED, 32, 32, 3)))
    lfae_vars = random_variables(dict(shapes), 1)
    jckpt.save_checkpoint(str(tmp / "lfae.msgpack"), lfae_vars)
    lfae_pth = str(tmp / "lfae.pth")
    assert convert_checkpoint.main(["--src", str(tmp / "lfae.msgpack"), "--out", lfae_pth,
                                    "--kind", "lfae"]) == 0
    argv = ["--config", cfg_path, "--arch", "tiny", "--device", "cpu", "--synthetic_videos",
            str(N_VIDEOS), "--num_sample_video", str(N_TRAJ), "--batch_size", "2", "--metrics",
            "psnr,ssim", "--flowae_checkpoint", lfae_pth, "--dump_arrays", "--dump_flow"]
    seen, calls = {}, []
    write, make_sampler = valid_dm.write_artefacts, FlowDiffusion.make_sampler

    def recording_make(self, decode=True):
        sampler = make_sampler(self, decode)
        return lambda *a, **k: calls.append(sampler(*a, **k)) or calls[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(config.ARCH_PRESETS, "tiny", TINY_ARCH)
        mp.setattr(valid_dm, "write_artefacts",
                   lambda args, fd, out, tc: (seen.setdefault("out", out),
                                              write(args, fd, out, tc)))
        mp.setattr(FlowDiffusion, "make_sampler", recording_make)
        assert valid_dm.main(argv + ["--log_dir", str(tmp / "w1")]) == 0
        mp.setattr(FlowDiffusion, "make_sampler", _halves_sampler(make_sampler))
        assert valid_dm.main(argv + ["--log_dir", str(tmp / "w1_ranks")]) == 0
    ranks.spawn(ranks.jobs, 2, str(tmp), TINY_ARCH,
                [("valid_dm", argv + ["--mesh_data", "2", "--log_dir", str(tmp / "w2")])], str(tmp))
    return {"tmp": tmp, "cfg_path": cfg_path, "lfae_vars": lfae_vars, "lfae_pth": lfae_pth,
            "out": seen["out"], "calls": calls}


def _files(d):
    return sorted(str(p.relative_to(d)) for p in Path(d).rglob("*") if p.is_file())


def test_valid_dm_writes_the_artefacts(runs):
    log, out = runs["tmp"] / "w1", runs["out"]
    T = 2 + 2  # the sampler's tc + tp: its sample_vid_grid's frames
    want = sorted(["metrics.txt", "sample0.gif", *ARRAYS]
                  + [f"flow_vis/{k}_t{t:03d}.png" for k in ("flow", "conf") for t in range(T)])
    assert _files(log) == want
    rng = np.random.RandomState(SEED)
    videos = np.stack([data.to_rgb_video(data.make_moving_shapes_video(rng, TC + TOTAL_PRED, 32)
                                         / np.float32(255.0)) for _ in range(N_VIDEOS)])
    origin = np.load(log / "origin.npy")
    np.testing.assert_array_equal(origin, videos)
    samples = out["samples"].numpy()
    np.testing.assert_array_equal(np.load(log / "result.npy"),
                                  samples.reshape(N_VIDEOS, N_TRAJ, *samples.shape[1:])[:, 0])
    # one loader batch of both videos: two sampler calls (rounds), no warm call
    grid, conf = ([c[k] for c in runs["calls"]] for k in ("sample_vid_grid", "sample_vid_conf"))
    assert len(grid) == 2
    rflows = np.load(log / "result_flows.npy")
    assert rflows.shape == (N_VIDEOS, TOTAL_PRED, 16, 16, 2)
    np.testing.assert_array_equal(
        rflows, torch.cat([g[::N_TRAJ, TC:] for g in grid], dim=1)[:, :TOTAL_PRED].numpy())
    for t in range(T):  # the first batch's last call, row 0
        np.testing.assert_array_equal(imageio.imread(log / "flow_vis" / f"flow_t{t:03d}.png"),
                                      flow_viz.flow2fig(grid[-1][0, t].numpy()))
        np.testing.assert_array_equal(imageio.imread(log / "flow_vis" / f"conf_t{t:03d}.png"),
                                      flow_viz.conf2fig(conf[-1][0, t].numpy()))
    jl = JLFAE(flow_params=tiny_flow_params())
    ref = jax.jit(lambda v, x: jl.apply(v, x, TC, method=JLFAE.encode_video))(
        runs["lfae_vars"], jnp.asarray(origin))
    oflows = np.load(log / "origin_flows.npy")
    assert oflows.shape == rflows.shape
    close(oflows, np.asarray(ref["flow"])[:, TC:], 2e-4)
    assert out["best_idx"] is None  # no FVD: sample0.gif shows trajectory 0


def test_mesh_data_2_writes_the_files_of_world_1(runs):
    tmp = runs["tmp"]
    w1, w2 = tmp / "w1_ranks", tmp / "w2"
    assert _files(w2) == _files(w1)
    for name in ARRAYS:
        a, b = np.load(w1 / name), np.load(w2 / name)
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5, err_msg=name)
    assert (w2 / "metrics.txt").read_text().splitlines()[:2] == \
        (w1 / "metrics.txt").read_text().splitlines()[:2]


@pytest.fixture
def gif_frames(monkeypatch):
    frames = {"jax": [], "port": []}
    for key, mod in (("jax", jvis), ("port", visualize)):
        monkeypatch.setattr(mod, "save_gif", lambda path, fr, fps=10, key=key: frames[
            key].append((os.path.basename(path), [np.array(f) for f in fr])))
    return frames


def test_analyze_dumps_matches_jax(runs, gif_frames, monkeypatch, capsys):
    log, tmp = runs["tmp"] / "w1", runs["tmp"]
    common = ["--dump_dir", str(log), "--cond_frames", str(TC), "--metrics", "psnr,ssim",
              "--per_video", "--render"]
    assert analyze_dumps.main(common + ["--out_dir", str(tmp / "an_port"), "--device",
                                        "cpu"]) == 0
    cli = _load_script("analyze_dumps")
    monkeypatch.setattr(sys, "argv", ["analyze_dumps.py"] + common + ["--out_dir",
                                                                     str(tmp / "an_jax")])
    cli.main()
    got, want = (json.load(open(tmp / d / "metrics.json")) for d in ("an_port", "an_jax"))
    assert sorted(got) == sorted(want) == ["psnr", "ssim"]
    for k in want:
        for stat in ("mean", "std"):
            assert abs(got[k][stat] - want[k][stat]) <= 1e-6
    assert (tmp / "an_port" / "metrics_per_video.csv").read_text() == \
        (tmp / "an_jax" / "metrics_per_video.csv").read_text()
    assert [n for n, _ in gif_frames["port"]] == [n for n, _ in gif_frames["jax"]]
    assert len(gif_frames["port"]) == N_VIDEOS
    for (_, pf), (_, jf) in zip(gif_frames["port"], gif_frames["jax"]):
        assert len(pf) == len(jf) == TC + TOTAL_PRED
        for a, b in zip(pf, jf):
            np.testing.assert_array_equal(a, b)


def test_analyze_dumps_without_dumps_fails(tmp_path, capsys):
    assert analyze_dumps.main(["--dump_dir", str(tmp_path), "--device", "cpu"]) == 1
    assert "valid_dm --dump_arrays" in capsys.readouterr().err


def test_video2video_matches_jax(runs, tmp_path, monkeypatch):
    seen = {}
    transfer = video2video.transfer

    def recording(lfae, hybrid, tc, device):
        seen["hybrid"], seen["out"] = hybrid, transfer(lfae, hybrid, tc, device)
        return seen["out"]

    monkeypatch.setattr(video2video, "transfer", recording)
    log = tmp_path / "v2v"
    assert video2video.main(["--config", runs["cfg_path"], "--flowae_checkpoint",
                             runs["lfae_pth"], "--synthetic_videos", "3", "--motion_indices",
                             "1,2", "--num_frames", "5", "--dump_flow", "--log_dir", str(log),
                             "--device", "cpu"]) == 0
    rng = np.random.RandomState(SEED)
    clips = [data.to_rgb_video(data.make_moving_shapes_video(rng, 5, 32) / np.float32(255.0))
             for _ in range(3)]
    hybrid = np.stack([clips[1], clips[2]])
    hybrid[:, TC - 1] = clips[0][TC - 1]  # scripts/video2video.py's hybrid videos
    np.testing.assert_array_equal(seen["hybrid"], hybrid)
    jl = JLFAE(flow_params=tiny_flow_params())
    ref = jax.jit(lambda v, x: jl.apply(v, x, TC, True, method=JLFAE.encode_video))(
        runs["lfae_vars"], jnp.asarray(hybrid))
    close(seen["out"]["out_vid"], np.asarray(ref["out_vid"]), 2e-4)
    close(seen["out"]["flow"], np.asarray(ref["flow"]), 2e-4)
    want = ["appearance.gif"] + [f"{k}_{i}.gif" for i in (1, 2) for k in ("motion", "transfer")]
    want += [f"flow_{i}/{k}_t{t:03d}.png" for i in (1, 2) for k in ("flow", "grid")
             for t in range(5)]
    assert _files(log) == sorted(want)


def test_converted_dm_checkpoint_resumes_train_dm(runs, tmp_path, monkeypatch, capsys):
    """A JAX DM train state after 2 updates at batch 2 (example 4), converted,
    resumes the port's DM job at step 2 (JAX's start_step) for one step;
    draw_curves.py then plots the job's metrics.jsonl."""
    monkeypatch.setitem(config.ARCH_PRESETS, "tiny", TINY_ARCH)
    cfg = yaml.safe_load(open(runs["cfg_path"]))
    tp = cfg["diffusion_params"]["train_params"]
    jfd = JFlowDiffusion(JConfig(flow_params=tiny_flow_params(), remat=False, cond_frames=TC,
                                 pred_frames=2, frame_shape=32, sampling_timesteps=2, **TINY_ARCH))
    params = random_variables(dict(jax.eval_shape(jfd.init_variables,
                                                  jax.random.PRNGKey(0))[1]["params"]), 3)
    tx = j_dm_trainer.make_optimizer(tp["lr"], tp["scheduler_param"]["milestones"],
                                     tp["scheduler_param"]["gamma"])
    opt = tx.init(params)
    opt = (opt[0]._replace(count=jnp.int32(2)), opt[1], opt[2]._replace(count=jnp.int32(2)))
    state = j_dm_trainer.DMTrainState(step=jnp.int32(2), unet_params=params, opt_state=opt)
    src, pth = str(tmp_path / "flowdiff.msgpack"), str(tmp_path / "flowdiff.pth")
    jckpt.save_checkpoint(src, {"example": 4, "step": 2, "state": state})
    assert convert_checkpoint.main(["--src", src, "--out", pth, "--kind", "dm", "--config",
                                    runs["cfg_path"], "--arch", "tiny"]) == 0
    log = tmp_path / "dm"
    assert train_dm.main(["--config", runs["cfg_path"], "--arch", "tiny", "--device", "cpu",
                          "--synthetic_videos", "4", "--batch_size", "2", "--valid_every", "0",
                          "--max_steps", "3", "--checkpoint", pth, "--set_start", "--log_dir",
                          str(log)]) == 0
    assert f"at step {jckpt.start_step_from_example(4, 2)}" in (log / "train.log").read_text()
    assert [r["step"] for r in loss_records(str(log), "loss")] == [2]
    assert checkpoint.load_checkpoint(str(log / "flowdiff.ckpt"))["optimizer"]["count"] == 3

    pytest.importorskip("matplotlib")
    cli = _load_script("draw_curves")
    jpg = tmp_path / "curves.jpg"
    monkeypatch.setattr(sys, "argv", ["draw_curves.py", "--log", str(log / "metrics.jsonl"),
                                      "--out", str(jpg)])
    cli.main()
    assert jpg.read_bytes()[:2] == b"\xff\xd8"  # a JPEG
