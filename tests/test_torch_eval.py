"""The port's evaluation loop (extdm_tpu_torch.eval.valid_dm.evaluate) against
the loop of scripts/valid_dm.py over the JAX package's sampler and metrics,
on the CPU, float32.

Tiny config (the one of tests/test_torch_dm.py, DDIM-3 at ddim_eta=0): 2
in-memory moving-shapes videos x 2 trajectories, tc=2, tp=2, 4 predicted
frames, so 2 autoregressive rounds; both packages get the same weights and
each sampler call the same init_noise, which makes the rollout
deterministic. Samples within 1e-3 (the bound of the sampler test: chained
UNet forwards carry float32 differences along the rollout); the metric
lines from them: PSNR 1e-2 dB, SSIM and LPIPS 1e-3, each FVD 1e-3 of its
size, the I3D (He-scaled, so that its features tell videos apart) and
LPIPS networks random and converted.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from extdm_tpu import metrics as jm
from extdm_tpu.metrics.i3d import InceptionI3d as JInceptionI3d
from extdm_tpu.models.dm.flow_diffusion import FlowDiffusion as JFlowDiffusion
from extdm_tpu.models.dm.flow_diffusion import FlowDiffusionConfig as JConfig
from extdm_tpu_torch import convert, data, metrics
from extdm_tpu_torch.eval import valid_dm
from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusion, FlowDiffusionConfig
from torch_port_helpers import he_scaled, random_variables, tiny_flow_params

CFG = dict(cond_frames=2, pred_frames=2, frame_shape=32, timesteps=1000, sampling_timesteps=3,
           ddim_eta=0.0, dim=16, dim_mults=(1, 2), attn_heads=2, attn_dim_head=8)
N_VIDEOS, N_TRAJ, TOTAL_PRED = 2, 2, 4


def jax_eval_loop(sample_fn, videos, noise, tc, tp, i3d, lpips):
    """scripts/valid_dm.py's loop and metrics on (N, T, H, W, 3) videos, one
    batch, with the given init_noise per round."""
    video_rep = np.repeat(videos, N_TRAJ, axis=0)
    cond, preds = video_rep[:, :tc], []
    for r in range(math.ceil(TOTAL_PRED / tp)):
        out = sample_fn(jax.random.PRNGKey(r), jnp.asarray(cond), init_noise=jnp.asarray(noise[r]))
        pred = np.asarray(out["sample_out_vid"][:, tc:])
        preds.append(pred)
        cond = pred[:, -tc:] if pred.shape[1] >= tc else np.concatenate(
            [np.asarray(cond)[:, pred.shape[1]:], pred], axis=1)
    samples = np.concatenate([video_rep[:, :tc], np.concatenate(preds, axis=1)[:, :TOTAL_PRED]],
                             axis=1)
    real_feats, traj_feats = i3d.get_feats(videos), i3d.get_feats(samples)
    best_idx = jm.best_trajectory_by_feature_distance(real_feats, traj_feats, N_TRAJ)
    tchw = lambda v: v.transpose(0, 1, 4, 2, 3)  # noqa: E731
    real_rep = np.repeat(videos, N_TRAJ, axis=0)
    return samples, dict(
        fvd_traj=[jm.calculate_fvd2(traj_feats[i::N_TRAJ], real_feats) for i in range(N_TRAJ)],
        fvd_best=jm.calculate_fvd2(traj_feats.reshape(N_VIDEOS, N_TRAJ, -1)[
            np.arange(N_VIDEOS), best_idx], real_feats),
        psnr2=jm.calculate_psnr2(tchw(samples), tchw(real_rep), N_TRAJ),
        ssim2=jm.calculate_ssim2(tchw(samples), tchw(real_rep), N_TRAJ),
        lpips2=lpips.calculate_lpips2(samples, real_rep, N_TRAJ))


def test_evaluate_matches_jax_loop(capsys):
    jfd = JFlowDiffusion(JConfig(flow_params=tiny_flow_params(), remat=False, **CFG))
    shapes = jax.eval_shape(jfd.init_variables, jax.random.PRNGKey(0))
    lfae_vars = random_variables(dict(shapes[0]), 1)
    unet_vars = {"params": random_variables(dict(shapes[1]["params"]), 2)}
    fd = FlowDiffusion(FlowDiffusionConfig(flow_params=tiny_flow_params(), **CFG), device="cpu")
    fd.lfae.load_state_dict(convert.lfae_state_dict(lfae_vars))
    fd.unet.load_state_dict(convert.unet_state_dict(unet_vars["params"]))

    jlpips = jm.LPIPSMetric(seed=0)
    i3d_shapes = jax.eval_shape(JInceptionI3d().init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 6, 224, 224, 3)))
    i3d_vars = he_scaled(random_variables(dict(i3d_shapes), 3))
    ji3d = jm.I3DExtractor(params=i3d_vars)

    tc, tp = CFG["cond_frames"], CFG["pred_frames"]
    rng = np.random.RandomState(5)
    clips = [data.make_moving_shapes_video(rng, tc + TOTAL_PRED, 32) for _ in range(N_VIDEOS)]
    noise = np.random.default_rng(6).normal(size=(2, N_VIDEOS * N_TRAJ, tp, 16, 16, 3))
    noise = noise.astype(np.float32)
    videos = np.stack([np.repeat(c[..., None] / np.float32(255.0), 3, -1) for c in clips])
    want_samples, want = jax_eval_loop(jfd.make_sampler(lfae_vars, unet_vars), videos, noise, tc,
                                       tp, ji3d, jlpips)

    dataset = data.VideoDataset(data.InMemoryVideoStore(clips), type="valid",
                                total_videos=N_VIDEOS, num_frames=tc + TOTAL_PRED, image_size=32,
                                random_time=False, raw_uint8=True)
    loader = data.DataLoader(dataset, N_VIDEOS, shuffle=False, num_workers=0, drop_last=False,
                             device="cpu")
    out = valid_dm.evaluate(
        fd, loader, num_traj=N_TRAJ, total_pred=TOTAL_PRED, seed=0,
        i3d=metrics.I3DExtractor(convert.i3d_state_dict(i3d_vars), device="cpu"),
        lpips=metrics.LPIPSMetric(convert.lpips_state_dict(
            jax.tree_util.tree_map(np.asarray, jlpips.params)), device="cpu"),
        init_noise=lambda b, r: torch.from_numpy(noise[r]))
    np.testing.assert_array_equal(out["real"].numpy(), videos)
    assert out["samples"].shape == want_samples.shape == (N_VIDEOS * N_TRAJ, 6, 32, 32, 3)
    np.testing.assert_allclose(out["samples"].numpy(), want_samples, rtol=1e-3, atol=1e-3)
    got = out["values"]
    print({k: (got[k], want[k]) for k in want})
    for k in ("fvd_traj", "fvd_best"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-3)
    assert abs(got["psnr2"] - want["psnr2"]) <= 1e-2
    assert abs(got["ssim2"] - want["ssim2"]) <= 1e-3
    assert abs(got["lpips2"] - want["lpips2"]) <= 1e-3
    assert [line.split(":")[0] for line in out["lines"]] == [
        "fvd_traj mean/std/conf95", "fvd_best", "i3d_pretrained", f"psnr2 (best-of-{N_TRAJ})",
        f"ssim2 (best-of-{N_TRAJ})", f"lpips2 (best-of-{N_TRAJ})", "lpips_pretrained",
        "sampling_frames_per_sec"]
    assert len(out["seconds"]["sampling_per_call"]) == 2 and got["sampling_frames_per_sec"] > 0


def test_evaluate_keeps_samples_in_host_memory_and_lines_unchanged(monkeypatch):
    """``evaluate`` moves each finished batch to host memory and scores PSNR,
    SSIM and LPIPS over slabs of real videos and their trajectories: its
    lines, at one video per slab and at a slab of all, equal the ones the
    whole-tensor metrics give on the real videos repeated num_traj times
    (what ``evaluate`` printed when it kept every sample on the device)."""
    fd = FlowDiffusion(FlowDiffusionConfig(flow_params=tiny_flow_params(), **CFG), device="cpu")
    tc, tp = CFG["cond_frames"], CFG["pred_frames"]
    rng = np.random.RandomState(7)
    clips = [data.make_moving_shapes_video(rng, tc + TOTAL_PRED, 32) for _ in range(N_VIDEOS)]
    dataset = data.VideoDataset(data.InMemoryVideoStore(clips), type="valid",
                                total_videos=N_VIDEOS, num_frames=tc + TOTAL_PRED, image_size=32,
                                random_time=False, raw_uint8=True)
    lpips = metrics.LPIPSMetric(device="cpu")
    outs = []
    for slab in (1, N_VIDEOS):
        monkeypatch.setattr(valid_dm, "SLAB_VIDEOS", slab)
        loader = data.DataLoader(dataset, 1, shuffle=False, num_workers=0, drop_last=False,
                                 device="cpu")
        outs.append(valid_dm.evaluate(fd, loader, num_traj=N_TRAJ, total_pred=TOTAL_PRED,
                                      seed=0, metrics=("psnr", "ssim", "lpips"), lpips=lpips))
    assert valid_dm.SLAB_VIDEOS == N_VIDEOS  # the second run's slabs: every video at once
    samples, real = outs[0]["samples"], outs[0]["real"]
    assert samples.device.type == real.device.type == "cpu"
    real_rep = real.repeat_interleave(N_TRAJ, dim=0)
    tchw = lambda v: v.permute(0, 1, 4, 2, 3)  # noqa: E731
    whole = [f"psnr2 (best-of-{N_TRAJ}): "
             f"{metrics.calculate_psnr2(tchw(samples), tchw(real_rep), N_TRAJ):.3f}",
             f"ssim2 (best-of-{N_TRAJ}): "
             f"{metrics.calculate_ssim2(tchw(samples), tchw(real_rep), N_TRAJ):.4f}",
             f"lpips2 (best-of-{N_TRAJ}): {lpips.calculate_lpips2(samples, real_rep, N_TRAJ):.4f}"]
    for out in outs:
        assert torch.equal(out["samples"], samples)
        assert out["lines"][:3] == whole
        assert out["lines"][3] == "lpips_pretrained: False"


def test_metric_stuff_matches_cli():
    """mean / std / conf95 as scripts/valid_dm.py computes them."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "scripts" / "valid_dm.py"
    spec = importlib.util.spec_from_file_location("_valid_dm_cli", path)
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    vals = np.array([3.0, 5.5, 4.25, 7.0])
    assert valid_dm.metric_stuff(vals) == cli.metric_stuff(vals)


def test_cli_runs_on_cpu_from_hdf5_and_memory(tmp_path, capsys):
    """``main`` end to end on the CPU at a shrunk shapes config (the shrink
    of tests/test_scripts.py): reference-layout HDF5 shards written by the
    JAX package, then the same videos made in memory; PSNR and SSIM."""
    import yaml

    from extdm_tpu.data import make_moving_shapes_video, write_video_hdf5

    cfg = yaml.safe_load(open("configs/DM/shapes.yaml"))
    dp = cfg["dataset_params"]
    dp.update(root_dir=str(tmp_path / "data"), frame_shape=32)
    dp["train_params"].update(cond_frames=2, pred_frames=2)
    dp["valid_params"].update(cond_frames=2, pred_frames=4, total_videos=2)
    fp = cfg["flow_params"]["model_params"]
    fp.update(tiny_flow_params())
    cfg["diffusion_params"]["model_params"]["sampling_timesteps"] = 2
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    rng = np.random.RandomState(1234)  # the CLI's --seed
    write_video_hdf5(np.stack([make_moving_shapes_video(rng, 6, 32) for _ in range(2)]),
                     str(tmp_path / "data" / "valid"))
    common = ["--config", str(path), "--num_sample_video", "2", "--batch_size", "2",
              "--metrics", "psnr,ssim", "--device", "cpu", "--stw_window_major", "auto"]
    lines = []
    for extra in ([], ["--synthetic_videos", "2"]):
        log_dir = tmp_path / f"log{len(lines)}"
        assert valid_dm.main(common + ["--log_dir", str(log_dir)] + extra) == 0
        lines.append((log_dir / "metrics.txt").read_text().splitlines())
    assert "WARNING: no --flowae_checkpoint" in capsys.readouterr().out
    # the in-memory videos are the shards' (same generator and seed)
    assert lines[0][:2] == lines[1][:2]
    assert lines[0][0].startswith("psnr2 (best-of-2): ") and lines[0][2].startswith(
        "sampling_frames_per_sec: ")
