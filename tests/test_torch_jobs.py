"""The two training jobs of the port (extdm_tpu_torch.train.train_dm and
train_ae, eval/valid_ae) against the JAX package's CLIs (scripts/train_dm.py,
scripts/train_ae.py) on the CPU, at tiny sizes: torch_port_helpers'
LFAE, 32 px, tc = tp = 2.

- Data and pictures: TwoFramesDataset / DatasetRepeater give JAX's pairs on
  the same HDF5 store and seed (raw uint8 exactly; float with the KTH flip +
  jitter within 1e-5); each augmentation op equals JAX's cv2 version within
  1e-5 (cv2 5.0 takes float coordinates in warpAffine and float HSV;
  measured within 3e-6); the DM shots and the region grid equal JAX's
  within one uint8 level; save_image and save_gif read back through imageio.
- The DM job: ``main`` trains two steps, validates, shoots, checkpoints and
  resumes with --set_start at step 2; its loop's two steps equal JAX
  DMTrainer's on the same clips, converted weights and t and noise
  (test_train_step_matches_jax's tolerances); a run resumed from the step-2
  checkpoint takes the step that the uninterrupted run takes, bit for bit;
  run_validation scores the held-out clips in JAX's order, and its metrics
  equal JAX's metric functions on its own samples.
- The AE job: ``main`` with and without --device_augment, then valid_ae on
  its checkpoint; its loop's steps equal JAX AETrainer's
  (test_ae_train_steps_match_jax's tolerances, step 2 from JAX's step-1
  state as there); run_ae_validation's metrics equal JAX's
  run_ae_validation's on the same weights and HDF5 store (I3D and LPIPS
  random and converted).
- Flags a launch cannot take raise (``--shard_map`` runs since the
  data-parallel port: tests/test_torch_parallel_jobs.py; ``--loader process``
  since the data-feed port: tests/test_torch_feed_jobs.py).
"""
import importlib.util
import json
import os
import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from extdm_tpu import data as jdata
from extdm_tpu import metrics as jm
from extdm_tpu.config import ae_model_kwargs as j_ae_model_kwargs
from extdm_tpu.data import augmentation as jaug
from extdm_tpu.metrics.i3d import InceptionI3d as JInceptionI3d
from extdm_tpu.models.dm.flow_diffusion import FlowDiffusion as JFlowDiffusion
from extdm_tpu.models.dm.flow_diffusion import FlowDiffusionConfig as JConfig
from extdm_tpu.models.lfae import recon_model as j_recon
from extdm_tpu.train import ae_trainer as j_ae_trainer
from extdm_tpu.train import dm_trainer as j_dm_trainer
from extdm_tpu.train import restore_like
from extdm_tpu.utils import visualize as jvis
from extdm_tpu_torch import config, convert, data, metrics
from extdm_tpu_torch.data import augmentation as aug
from extdm_tpu_torch.eval import valid_ae, valid_dm
from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusion, FlowDiffusionConfig
from extdm_tpu_torch.models.lfae import transform
from extdm_tpu_torch.models.lfae.recon_model import ReconstructionModel
from extdm_tpu_torch.train import ae_trainer, checkpoint, dm_trainer, train_ae, train_dm
from extdm_tpu_torch.train.job import Cadence
from extdm_tpu_torch.utils import visualize
from test_torch_ae import jax_augment_draws, load_jax_state
from torch_port_helpers import he_scaled, random_variables, tiny_flow_params

t_ = torch.from_numpy
REPO = Path(__file__).resolve().parents[1]
KTH_AUG = yaml.safe_load(open(REPO / "configs" / "AE" / "kth.yaml"))["dataset_params"][
    "augmentation_params"]
DM_CFG = dict(cond_frames=2, pred_frames=2, frame_shape=32, timesteps=1000, sampling_timesteps=2,
              ddim_eta=0.0, dim=16, dim_mults=(1,), attn_heads=2, attn_dim_head=8)
TINY_ARCH = dict(use_ref_features=True, conditioning="adaptor", dim=16, dim_mults=(1, 2),
                 attn_heads=2, attn_dim_head=8)
N_VALID = 2


def tiny_yaml(tmp_path, root_dir="/nonexistent"):
    """configs/DM/kth.yaml shrunk as tests/test_scripts.py shrinks the shapes
    config (the tiny LFAE, 32 px, tc = tp = 2, DDIM-2), with every cadence
    at 1 and the AE train_params of that shrink."""
    cfg = yaml.safe_load(open(REPO / "configs" / "DM" / "kth.yaml"))
    dp = cfg["dataset_params"]
    dp.update(root_dir=str(root_dir), frame_shape=32, max_frame_distance=5)
    dp["train_params"].update(cond_frames=2, pred_frames=2)
    dp["valid_params"].update(cond_frames=2, pred_frames=2, total_videos=N_VALID)
    cfg["flow_params"]["model_params"] = tiny_flow_params()
    cfg["diffusion_params"]["model_params"]["sampling_timesteps"] = 2
    cfg["diffusion_params"]["train_params"].update(
        batch_size=2, dataloader_workers=0, print_freq=1, update_ckpt_freq=1, save_img_freq=1,
        save_vid_freq=1)
    cfg["flow_params"]["train_params"] = dict(
        max_epochs=1, num_repeats=1, lr=2.0e-4, batch_size=2, dataloader_workers=0, print_freq=1,
        update_ckpt_freq=1, save_img_freq=1, scheduler_param=dict(milestones=[100], gamma=0.5),
        scales=[1, 0.5], transform_params=dict(sigma_affine=0.05, sigma_tps=0.005, points_tps=5),
        loss_weights=dict(perceptual=[1, 1, 1, 1, 1], equivariance_shift=10,
                          equivariance_affine=10, reconstruction=10))
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path), cfg


# XLA's CPU backend at its lowest optimisation level: the JAX train steps
# compile in about half the time, to the same float32 results at these bounds
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def fast_jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)


def records(log_dir):
    return [json.loads(line) for line in open(os.path.join(log_dir, "metrics.jsonl"))]


def loss_records(log_dir, key):
    return [r for r in records(log_dir) if key in r]


# ---------------------------------------------------------------- data
@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """Three moving-shapes videos of 12 frames (the JAX package's generator),
    as JAX's HDF5 shards under <root>/train and as an in-memory store."""
    root = tmp_path_factory.mktemp("pairs")
    rng = np.random.RandomState(3)
    videos = np.stack([jdata.make_moving_shapes_video(rng, 12, 32) for _ in range(3)])
    jdata.write_video_hdf5(videos, str(root / "train"))
    return str(root), data.InMemoryVideoStore(list(videos))


@pytest.mark.parametrize("raw", [True, False], ids=["raw_uint8", "float_flip_jitter"])
def test_two_frames_pairs_match_jax(store, raw):
    root, memory = store
    kw = dict(type="train", frame_shape=32, min_frame_distance=1, max_frame_distance=5,
              augmentation_params=None if raw else KTH_AUG, seed=5, raw_uint8=raw)

    def items(ds, n=6):
        random.seed(7)
        np.random.seed(7)
        return [ds[i] for i in range(n)]

    want = items(jdata.DatasetRepeater(jdata.TwoFramesDataset(root, **kw), 2))
    sources = [root] + ([memory] if raw else [])
    for src in sources:
        got = items(data.DatasetRepeater(data.TwoFramesDataset(src, **kw), 2))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a["frame"], b["frame"])
            for k in ("source", "driving"):
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=0 if raw else 1e-5)
    if not raw:  # whole batches: batch_call over numpy's global stream
        batches = []
        for mod in (jdata, data):
            random.seed(9)
            np.random.seed(9)
            batches.append(mod.DatasetRepeater(mod.TwoFramesDataset(root, **kw), 2)
                           .get_batch([0, 4, 2, 5]))
        for k in ("source", "driving", "frame", "id"):
            np.testing.assert_allclose(batches[1][k], batches[0][k], rtol=0, atol=1e-5)


OPS = {
    "flip": lambda m: m.RandomFlip(time_flip=True, horizontal_flip=True),
    "resize_nearest": lambda m: m.RandomResize(ratio=(0.7, 1.4), interpolation="nearest"),
    "resize_linear": lambda m: m.RandomResize(ratio=(0.7, 1.4), interpolation="linear"),
    "crop": lambda m: m.RandomCrop(24),
    "crop_pad": lambda m: m.RandomCrop((36, 40)),
    "rotation": lambda m: m.RandomRotation(15),
    "jitter": lambda m: m.ColorJitter(0.3, 0.3, 0.3, 0.3),
    "all": lambda m: m.AllAugmentationTransform(
        resize_param={"ratio": (0.9, 1.1), "interpolation": "linear"},
        rotation_param={"degrees": 10}, flip_param={"horizontal_flip": True},
        crop_param={"size": 28}, jitter_param={"brightness": 0.1, "hue": 0.2}),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_augmentation_ops_match_cv2(op):
    """Each op on a smooth RGB clip of 3 frames, the same `random` state,
    against the JAX package's (cv2) op, 1e-5."""
    yy, xx = np.mgrid[:32, :30] / 30.0
    clip = [np.stack([0.5 + 0.4 * np.sin(6 * xx + t), 0.5 + 0.4 * np.cos(5 * yy - t),
                      (xx + yy) / 2.2], -1).astype(np.float32) for t in range(3)]
    for seed in range(4):
        random.seed(seed)
        want = OPS[op](jaug)(clip)
        random.seed(seed)
        got = OPS[op](aug)(clip)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=f"{op} seed {seed}")


def _monitor_ret(rng, tc=2, tp=2, px=32, h=16):
    u = lambda *s: rng.uniform(size=s).astype(np.float32)  # noqa: E731
    grid = lambda t: np.clip(rng.normal(scale=0.6, size=(1, t, h, h, 2)), -1, 1).astype(  # noqa
        np.float32)
    return {"ref_imgs": u(1, px, px, 3), "real_out_vid": u(1, tc + tp, px, px, 3),
            "real_warped_vid": u(1, tc + tp, px, px, 3), "real_vid_grid": grid(tc + tp),
            "real_vid_conf": u(1, tc + tp, h, h, 1), "fake_out_vid": u(1, tp, px, px, 3),
            "fake_warped_vid": u(1, tp, px, px, 3), "fake_vid_grid": grid(tp),
            "fake_vid_conf": None}


def test_pictures_match_jax(tmp_path):
    """dm_imgshot / dm_vidshot and the region grid (cv2.resize and
    matplotlib's gist_rainbow in the JAX package) within one uint8 level."""
    rng = np.random.default_rng(3)
    ret, video = _monitor_ret(rng), rng.uniform(size=(1, 4, 32, 32, 3)).astype(np.float32)
    want = [jvis.dm_imgshot(ret, video, 2, 2)] + jvis.dm_vidshot(ret, video, 2, 2)
    got = [visualize.dm_imgshot(ret, video, 2, 2)] + visualize.dm_vidshot(ret, video, 2, 2)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.dtype == np.uint8 and a.shape == b.shape == (64, 160, 3)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    B, K = 2, 5
    out = {"source_region_params": {"shift": rng.uniform(-1, 1, (B, K, 2)),
                                    "heatmap": rng.uniform(size=(B, 16, 16, K))},
           "driving_region_params": {"shift": rng.uniform(-1, 1, (B, K, 2))},
           "prediction": rng.uniform(size=(B, 32, 32, 3)),
           "deformed": rng.uniform(size=(B, 32, 32, 3)),
           "occlusion_map": rng.uniform(size=(B, 16, 16, 1))}
    out = jax.tree_util.tree_map(lambda a: a.astype(np.float32), out)
    src, drv = (rng.uniform(size=(B, 32, 32, 3)).astype(np.float32) for _ in range(2))
    for index in (0, 1):
        want = jvis.RegionVisualizer(kp_size=2).visualize(src, drv, out, index)
        got = visualize.RegionVisualizer(kp_size=2).visualize(src, drv, out, index)
        assert got.shape == want.shape == (64, 96, 3)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_png_and_gif_read_back(tmp_path):
    import imageio.v2 as imageio

    rng = np.random.default_rng(4)
    rgb, gray = rng.integers(0, 256, (21, 34, 3), np.uint8), rng.integers(0, 256, (9, 13), np.uint8)
    for name, img in (("rgb", rgb), ("gray", gray)):
        visualize.save_image(str(tmp_path / f"{name}.png"), img)
        np.testing.assert_array_equal(imageio.imread(tmp_path / f"{name}.png"), img)
    # noise fills the LZW table (a clear code mid-frame); a smooth frame compresses
    yy, xx = np.mgrid[:40, :70]
    frames = [rng.integers(0, 256, (40, 70, 3), np.uint8),
              np.stack([xx * 3, yy * 6, (xx + yy) * 2], -1).astype(np.uint8)]
    visualize.save_gif(str(tmp_path / "a.gif"), frames, fps=5)
    back = imageio.mimread(tmp_path / "a.gif")
    assert len(back) == 2
    for b, f in zip(back, frames):
        np.testing.assert_array_equal(b[..., :3], visualize.GIF_PALETTE[visualize.gif_indices(f)])
        assert np.abs(b[..., :3].astype(int) - f).max() <= 43  # half of 255 / 3 levels


# ------------------------------------------------------------------ flags
@pytest.mark.parametrize("job,flag,error,match", [
    # ported since: a process alone is no (1 x 2) mesh; --loader process runs
    # (tests/test_torch_feed_jobs.py)
    ("valid_dm", "--mesh_model=2", ValueError, "--mesh_model 2 in a launch of 1 process")])
def test_unported_flags_raise(job, flag, error, match):
    main = {"dm": train_dm, "ae": train_ae, "valid_dm": valid_dm}[job].main
    with pytest.raises(error, match=match):
        main(["--config", "unused.yaml", "--device", "cpu", flag])


# ---------------------------------------------------------------- DM job
def test_dm_job_trains_validates_shoots_and_resumes(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(config.ARCH_PRESETS, "tiny", TINY_ARCH)
    cfg_path, _ = tiny_yaml(tmp_path)
    log, log2 = str(tmp_path / "dm"), str(tmp_path / "dm2")
    common = ["--config", cfg_path, "--arch", "tiny", "--device", "cpu", "--synthetic_videos",
              "4", "--batch_size", "2", "--nan_guard", "2"]
    assert train_dm.main(common + ["--max_steps", "2", "--valid_every", "1", "--valid_videos",
                                   "2", "--log_dir", log]) == 0
    steps = [r["step"] for r in loss_records(log, "loss")]
    assert steps == [0, 1]
    assert all(np.isfinite(r["loss"]) and r["skipped_nonfinite"] == 0
               for r in loss_records(log, "loss"))
    (vm,) = loss_records(log, "valid_ssim")
    assert vm["step"] == 1 and vm["i3d_pretrained"] == 0 and vm["valid_seconds"] > 0
    assert [r["step"] for r in loss_records(log, "ckpt_seconds")] == [1]
    files = sorted(os.listdir(log))
    assert {"train.log", "metrics.jsonl", "flowdiff.ckpt", "imgshots", "vidshots"} <= set(files)
    assert any(f.startswith("flowdiff_ssim_best_") for f in files)
    assert os.listdir(os.path.join(log, "imgshots")) == ["B0002_S000001.png"]
    assert os.listdir(os.path.join(log, "vidshots")) == ["B0002_S000001.gif"]
    ckpt = checkpoint.load_checkpoint(os.path.join(log, "flowdiff.ckpt"))
    assert (ckpt["step"], ckpt["example"], ckpt["optimizer"]["count"]) == (2, 4, 2)
    assert "step 1: loss=" in open(os.path.join(log, "train.log")).read()

    assert train_dm.main(common + ["--max_steps", "3", "--valid_every", "0", "--log_dir", log2,
                                   "--checkpoint", os.path.join(log, "flowdiff.ckpt"),
                                   "--set_start"]) == 0
    assert "at step 2" in open(os.path.join(log2, "train.log")).read()
    assert [r["step"] for r in loss_records(log2, "loss")] == [2]
    assert checkpoint.load_checkpoint(os.path.join(log2, "flowdiff.ckpt"))["optimizer"][
        "count"] == 3
    fd = FlowDiffusion(config.dm_config_from_yaml(yaml.safe_load(open(cfg_path)), arch="tiny"),
                       device="cpu")
    valid_dm.load_weights(fd, "", os.path.join(log2, "flowdiff.ckpt"))
    assert "WARNING: no --flowae_checkpoint" in capsys.readouterr().out


def _jax_draws(key, b, shape):
    key_t, key_noise = jax.random.split(key)
    t = jax.random.randint(key_t, (b,), 0, 1000)
    noise = jax.random.normal(key_noise, shape, jnp.float32)
    return t_(np.array(t)).long(), t_(np.array(noise))


@pytest.fixture(scope="module")
def jax_dm():
    """The JAX FlowDiffusion at DM_CFG, its random LFAE variables and UNet
    parameters, and a port FlowDiffusion factory on their conversions."""
    jfd = JFlowDiffusion(JConfig(flow_params=tiny_flow_params(), remat=False, **DM_CFG))
    shapes = jax.eval_shape(jfd.init_variables, jax.random.PRNGKey(0))
    lfae_vars = random_variables(dict(shapes[0]), 1)
    unet_params = random_variables(dict(shapes[1]["params"]), 2)

    def port_fd():
        fd = FlowDiffusion(FlowDiffusionConfig(flow_params=tiny_flow_params(), **DM_CFG),
                           device="cpu")
        fd.lfae.load_state_dict(convert.lfae_state_dict(lfae_vars))
        fd.unet.load_state_dict(convert.unet_state_dict(unet_params))
        return fd

    return jfd, lfae_vars, unet_params, port_fd


def test_dm_monitor_matches_jax(jax_dm):
    """FlowDiffusion.make_monitor against JAX's monitor on the same converted
    weights, clip, t and noise: every key of the shot dict, the real_* from
    the LFAE's full encode and the fake_* from the decode of p_losses'
    pred_x0, within 1e-4 (tests/test_torch_lfae.py's bound for the LFAE)."""
    jfd, lfae_vars, unet_params, port_fd = jax_dm
    video = np.random.default_rng(17).uniform(size=(2, 4, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(23)
    args = (lfae_vars, {"params": unet_params}, key, jnp.asarray(video))
    want = fast_jit(jfd.make_monitor(), *args)(*args)
    t, noise = _jax_draws(key, 2, (2, 2, 16, 16, 3))
    got = port_fd().make_monitor()(None, t_(video), t=t, noise=noise)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_dm_job_steps_match_jax_and_resume(tmp_path, jax_dm):
    """Two steps of the job's loop against JAX DMTrainer's, then step 3: the
    same trainer going on, and a fresh one restored from the checkpoint the
    first two steps wrote, bit for bit."""
    LR = 1e-3
    jfd, lfae_vars, unet_params, port_fd = jax_dm
    rng = np.random.default_rng(16)
    clips = [rng.integers(0, 256, size=(2, 4, 32, 32), dtype=np.uint8) for _ in range(3)]
    keys = [jax.random.PRNGKey(21 + i) for i in range(3)]
    trainer = j_dm_trainer.DMTrainer(jfd, j_dm_trainer.make_optimizer(LR, (1,), 0.5))
    state = trainer.init_state({"params": unet_params})
    step = fast_jit(trainer.train_step, state, lfae_vars, keys[0], jnp.asarray(clips[0]))
    jaux = []
    for key, clip in zip(keys[:2], clips):
        state, aux = step(state, lfae_vars, key, jnp.asarray(clip))
        jaux.append({k: float(v) for k, v in aux.items()})

    def port_trainer():
        fd = port_fd()
        return dm_trainer.DMTrainer(fd, dm_trainer.make_optimizer(fd.unet.parameters(), LR,
                                                                  (1,), 0.5))

    draws = lambda s: _jax_draws(keys[s], 2, (2, 2, 16, 16, 3))  # noqa: E731
    batches = [(t_(c), np.arange(2)) for c in clips]
    root = torch.Generator().manual_seed(0)
    port = port_trainer()
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    kw = dict(root=root, batch_size=2, draws=draws)
    assert train_dm.train_loop(port, batches[:2], Cadence(2, print_freq=1, save_freq=10 ** 6),
                               a, **kw) == 2
    for got, want in zip(loss_records(a, "loss"), jaux):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=2e-4, atol=2e-4)
    ref = convert.unet_state_dict(state.unet_params)
    for name, p in port.fd.unet.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref[name]), rtol=0,
                                   atol=2 * LR, err_msg=name)

    ckpt = checkpoint.load_checkpoint(os.path.join(a, "flowdiff.ckpt"))
    assert (ckpt["step"], ckpt["example"]) == (2, 4)
    resumed = port_trainer()
    checkpoint.restore_dm(ckpt, resumed.fd.unet, resumed.optimizer)
    start = checkpoint.start_step_from_example(ckpt["example"], 2)
    for trainer_, d in ((port, a), (resumed, b)):
        train_dm.train_loop(trainer_, batches[2:], Cadence(3, start_step=start, print_freq=1,
                                                           save_freq=10 ** 6), d, **kw)
    assert loss_records(a, "loss")[-1]["loss"] == loss_records(b, "loss")[-1]["loss"]
    for (n, p), q in zip(port.fd.unet.named_parameters(), resumed.fd.unet.parameters()):
        assert torch.equal(p, q), n
        sa, sb = port.optimizer.opt.state[p], resumed.optimizer.opt.state[q]
        assert all(torch.equal(sa[k], sb[k]) for k in ("exp_avg", "exp_avg_sq", "step"))
    assert port.optimizer.count == resumed.optimizer.count == 3


# ------------------------------------------------------------- validation
@pytest.fixture(scope="module")
def nets():
    """Random I3D (He-scaled) and LPIPS networks of the JAX package and their
    conversions for the port."""
    from extdm_tpu.metrics.lpips import LPIPS as JLPIPS

    zeros = jnp.zeros((1, 64, 64, 3))
    lpips_vars = random_variables(dict(jax.eval_shape(JLPIPS(spatial=True).init,
                                                      jax.random.PRNGKey(0), zeros, zeros)), 4)
    shapes = jax.eval_shape(JInceptionI3d().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 6, 224, 224, 3)))
    i3d_vars = he_scaled(random_variables(dict(shapes), 3))
    i3d_sd = convert.i3d_state_dict(i3d_vars)
    return dict(ji3d=jm.I3DExtractor(params=i3d_vars), jlpips=jm.LPIPSMetric(params=lpips_vars),
                i3d_sd=i3d_sd, i3d=metrics.I3DExtractor(i3d_sd, device="cpu"),
                lpips=metrics.LPIPSMetric(convert.lpips_state_dict(lpips_vars), device="cpu"))


@pytest.fixture(scope="module")
def valid_store(tmp_path_factory):
    """N_VALID moving-shapes videos of 6 frames as JAX's HDF5 shards under
    <root>/valid."""
    root = tmp_path_factory.mktemp("valid")
    rng = np.random.RandomState(11)
    jdata.write_video_hdf5(np.stack([jdata.make_moving_shapes_video(rng, 6, 32)
                                     for _ in range(N_VALID)]), str(root / "valid"))
    return str(root)


def jax_metrics(fake, real, n):
    tchw = lambda v: v.transpose(0, 1, 4, 2, 3)  # noqa: E731
    psnr, _ = jm.calculate_psnr1(tchw(fake), tchw(real))
    ssim, _ = jm.calculate_ssim1(tchw(fake), tchw(real))
    return {"valid_fvd": jm.calculate_fvd2(n["ji3d"].get_feats(fake), n["ji3d"].get_feats(real)),
            "valid_psnr": float(psnr["psnr"]), "valid_ssim": float(ssim["ssim"]),
            "valid_lpips": float(n["jlpips"].calculate_lpips1(fake, real)[0]["lpips"])}


def assert_metrics_close(got, want):
    """PSNR 1e-2 dB, SSIM and LPIPS 1e-3, FVD 1e-3 of its size (the bounds
    of tests/test_torch_eval.py)."""
    assert abs(got["valid_psnr"] - want["valid_psnr"]) <= 1e-2
    assert abs(got["valid_ssim"] - want["valid_ssim"]) <= 1e-3
    assert abs(got["valid_lpips"] - want["valid_lpips"]) <= 1e-3
    np.testing.assert_allclose(got["valid_fvd"], want["valid_fvd"], rtol=1e-3, atol=1e-3)


def test_dm_run_validation_clips_and_metrics(valid_store, nets, monkeypatch):
    """The validation's clips are JAX run_validation's (VideoDataset at seed
    1234, in order, its cond frames spliced into the samples), and its
    metrics are JAX's metric functions on the port's own samples."""
    _, cfg = tiny_yaml(Path(valid_store), root_dir=valid_store)
    fd = FlowDiffusion(FlowDiffusionConfig(flow_params=tiny_flow_params(), **DM_CFG),
                       device="cpu")
    seen = {}
    real_metrics = train_dm.video_metrics

    def spy(fake, real, i3d, lpips):
        seen.update(fake=fake.numpy(), real=real.numpy())
        return real_metrics(fake, real, i3d, lpips)

    monkeypatch.setattr(train_dm, "video_metrics", spy)
    vm = train_dm.run_validation(fd, cfg, valid_store, torch.Generator().manual_seed(0),
                                 num_videos=N_VALID, batch_size=1, i3d=nets["i3d"],
                                 lpips=nets["lpips"])
    ds = jdata.VideoDataset(valid_store, type="valid", total_videos=N_VALID, num_frames=4,
                            image_size=32, random_time=False, seed=1234)
    real = np.stack([jdata.to_rgb_video(ds[i][0]) for i in range(N_VALID)])
    np.testing.assert_array_equal(seen["real"], real)
    np.testing.assert_array_equal(seen["fake"][:, :2], real[:, :2])
    assert seen["fake"].shape == real.shape and np.isfinite(seen["fake"]).all()
    assert_metrics_close(vm, jax_metrics(seen["fake"], seen["real"], nets))
    assert vm["i3d_pretrained"] == 1.0 and vm["lpips_pretrained"] == 1.0


# ---------------------------------------------------------------- AE job
@pytest.mark.parametrize("device_augment", [True, False], ids=["device_augment", "host"])
def test_ae_job_trains_validates_shoots_resumes_and_valid_ae(tmp_path, device_augment):
    cfg_path, _ = tiny_yaml(tmp_path)
    log, log2 = str(tmp_path / "ae"), str(tmp_path / "ae2")
    common = ["--config", cfg_path, "--device", "cpu", "--synthetic_videos", "4",
              "--batch_size", "2", "--learnable_loss_weights"] + (
        ["--device_augment"] if device_augment else [])
    assert train_ae.main(common + ["--max_steps", "2", "--valid_every", "1", "--valid_videos",
                                   "2", "--valid_batch_size", "2", "--log_dir", log]) == 0
    losses = loss_records(log, "loss_total")
    assert [r["step"] for r in losses] == [0, 1]
    assert all(np.isfinite(r["loss_total"]) for r in losses)
    (vm,) = loss_records(log, "valid_ssim")
    assert vm["step"] == 1 and np.isfinite(vm["valid_fvd"])
    files = set(os.listdir(log))
    assert {"train.log", "metrics.jsonl", "RegionMM.ckpt", "imgshots"} <= files
    assert any(f.startswith("RegionMM_ssim_best_") for f in files)
    assert os.listdir(os.path.join(log, "imgshots")) == ["step0000001.png"]
    ckpt = checkpoint.load_checkpoint(os.path.join(log, "RegionMM.ckpt"))
    assert {"generator", "bg_predictor", "region_predictor", "vgg", "loss_weights"} <= set(ckpt)
    assert (ckpt["step"], ckpt["example"], ckpt["optimizer"]["count"]) == (2, 4, 2)

    assert train_ae.main(common + ["--max_steps", "3", "--valid_every", "0", "--log_dir", log2,
                                   "--checkpoint", os.path.join(log, "RegionMM.ckpt"),
                                   "--set_start"]) == 0
    assert "at step 2" in open(os.path.join(log2, "train.log")).read()
    assert [r["step"] for r in loss_records(log2, "loss_total")] == [2]

    out = str(tmp_path / "valid_ae")
    assert valid_ae.main(["--config", cfg_path, "--device", "cpu", "--synthetic_videos", "2",
                          "--batch_size", "2", "--log_dir", out, "--checkpoint",
                          os.path.join(log2, "RegionMM.ckpt")]) == 0
    res = json.load(open(os.path.join(out, "metrics.json")))
    assert set(res) == {"fvd", "psnr", "ssim", "l1_out_loss", "l1_warp_loss", "fps",
                        "i3d_pretrained"}
    assert all(np.isfinite(v) for v in res.values())


def _load_jax_cli(name, monkeypatch):
    """scripts/<name>.py as a module, its compilation-cache call a no-op."""
    from extdm_tpu.utils import cache

    monkeypatch.setattr(cache, "enable_compilation_cache", lambda *a, **k: None)
    spec = importlib.util.spec_from_file_location(f"_{name}_cli", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ae_job_steps_and_validation_match_jax(tmp_path, valid_store, nets, monkeypatch):
    """Two steps of the job's loop against JAX AETrainer's on raw uint8
    pairs with the KTH flip + jitter on the device and learnable loss
    weights, the port fed JAX's augmentation and TPS draws: step 1's losses
    to 1e-5 relative, its params within 2.2 lr, loss weights 1e-6 and
    statistics 1e-5; step 2 from JAX's step-1 state (as
    test_ae_train_steps_match_jax), params 2.2 lr, statistics 1e-4. Then
    run_ae_validation on JAX's step-2 weights against JAX's
    run_ae_validation on the same HDF5 store. The perceptual loss is off here
    (its VGG19 doubles the JAX step's compile; tests/test_torch_ae.py holds
    it): the job's part is the batches, draws, schedule and state it feeds
    the trainer."""
    _, cfg = tiny_yaml(tmp_path, root_dir=valid_store)
    tp = cfg["flow_params"]["train_params"]
    tp["loss_weights"]["perceptual"] = [0, 0, 0, 0, 0]
    LR = tp["lr"]
    dev_aug = {"flip_param": KTH_AUG["flip_param"], "jitter_param": KTH_AUG["jitter_param"]}
    jmodel = j_recon.ReconstructionModel(train=True, **j_ae_model_kwargs(cfg))
    zeros = jnp.zeros((2, 32, 32, 3))
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "tps": jax.random.PRNGKey(1)},
        {"source": zeros, "driving": zeros}))
    variables = random_variables(dict(shapes), 7)
    rng = np.random.default_rng(8)
    batches = [{k: rng.integers(26, 230, size=(2, 32, 32), dtype=np.uint8)
                for k in ("source", "driving")} for _ in range(2)]
    keys = [jax.random.PRNGKey(30 + i) for i in range(2)]
    draws = []
    real_random_tps = j_recon.random_tps

    def recording_random_tps(key, batch, **params):
        t = real_random_tps(key, batch, **params)
        jax.debug.callback(lambda *a: draws.append([np.array(v) for v in a]),
                           t.theta, t.control_points, t.control_params)
        return t

    jtrainer = j_ae_trainer.AETrainer(
        jmodel, j_ae_trainer.make_optimizer(LR, tp["scheduler_param"]["milestones"],
                                            tp["scheduler_param"]["gamma"], nan_guard=1),
        learnable_loss_weights=True, device_augment=dev_aug)
    state = jtrainer.init_state(variables)
    jstates, jaux = [], []
    with monkeypatch.context() as mp:
        mp.setattr(j_recon, "random_tps", recording_random_tps)
        jbatches = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
        step = fast_jit(jtrainer.train_step, state, keys[0], jbatches[0])
        for key, batch in zip(keys, jbatches):
            state, aux = step(state, key, batch)
            jax.block_until_ready(state)
            jstates.append(state)
            jaux.append({k: float(v) for k, v in aux.items()})

    model = ReconstructionModel(**config.ae_model_kwargs(cfg))
    model.load_state_dict(convert.recon_state_dict(variables))
    port = ae_trainer.AETrainer(model, ae_trainer.make_optimizer(
        LR, tp["scheduler_param"]["milestones"], tp["scheduler_param"]["gamma"], nan_guard=1),
        learnable_loss_weights=True, device_augment=dev_aug, device="cpu")

    def port_draws(s):
        tps = transform.TPSTransform(*(t_(a) for a in draws[s]))
        return tps, jax_augment_draws(jax.random.split(keys[s])[0], 2, (32, 32), **dev_aug)

    pbatches = [{k: t_(v) for k, v in b.items()} for b in batches]
    kw = dict(root=torch.Generator().manual_seed(0), batch_size=2, draws=port_draws)
    log = str(tmp_path / "ae")
    for i, stats_tol in ((0, 1e-5), (1, 1e-4)):
        if i == 1:
            load_jax_state(port, jstates[0])
        train_ae.train_loop(port, pbatches[i:i + 1],
                            Cadence(i + 1, start_step=i, print_freq=1, save_freq=10 ** 6),
                            log, **kw)
        if i == 0:
            got = loss_records(log, "loss_total")[0]
            for k, v in jaux[0].items():
                np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)
        sd = model.state_dict()
        jstate = jstates[i]
        for name, want in convert.recon_state_dict({"params": jstate.params}).items():
            np.testing.assert_allclose(sd[name].numpy(), want.numpy(), rtol=0, atol=2.2 * LR,
                                       err_msg=name)
        for k, v in jstate.loss_weights.items():
            np.testing.assert_allclose(port.loss_weights[k].item(), float(v), rtol=0, atol=1e-6)
        stats = convert.recon_state_dict({"batch_stats": jstate.batch_stats})
        for name, want in stats.items():
            if not name.endswith("num_batches_tracked"):
                np.testing.assert_allclose(sd[name].numpy(), want.numpy(), rtol=0,
                                           atol=stats_tol * max(1.0, want.abs().max().item()),
                                           err_msg=f"step {i + 1} {name}")
    assert [r["step"] for r in loss_records(log, "loss_total")] == [0, 1]

    # validation on JAX's step-2 weights, in both packages
    load_jax_state(port, jstates[1])
    cli = _load_jax_cli("train_ae", monkeypatch)
    monkeypatch.setattr(jm, "I3DExtractor", lambda: nets["ji3d"])
    monkeypatch.setattr(jm, "LPIPSMetric", lambda: nets["jlpips"])
    jcache = {}
    want = cli.run_ae_validation(cfg, jstates[1], 1234, N_VALID, 1, jcache)
    got = train_ae.run_ae_validation(cfg, model, valid_store, N_VALID, 1,
                                     {"i3d": nets["i3d"], "lpips": nets["lpips"]}, seed=1234,
                                     device="cpu")
    assert_metrics_close(got, want)
    assert got["i3d_pretrained"] == want["i3d_pretrained"] == 1.0
    assert got["lpips_pretrained"] == want["lpips_pretrained"] == 1.0

    # valid_ae on a checkpoint of the same weights against scripts/valid_ae.py's
    # loop (JAX's full encode of the same clips in order, then its metric
    # functions); the L1 losses (x10) within 10 times the LFAE's 1e-4
    parts = ("region_predictor", "bg_predictor", "generator")
    jvars = restore_like(jcache["template"], {
        "params": {k: jstates[1].params[k] for k in parts},
        "batch_stats": {k: jstates[1].batch_stats.get(k, {}) for k in parts}})
    ds = jdata.VideoDataset(valid_store, type="valid", total_videos=N_VALID, num_frames=4,
                            image_size=32, random_time=False, seed=1234)
    real = np.stack([jdata.to_rgb_video(ds[i][0]) for i in range(N_VALID)])
    outs = [jcache["encode"](jvars, jnp.asarray(v[None])) for v in real]
    recon, warped = (np.concatenate([np.asarray(o[k]) for o in outs])
                     for k in ("out_vid", "warped_vid"))
    jres = jax_metrics(recon, real, nets)
    ckpt, i3d_file, out = (str(tmp_path / f) for f in ("ae.ckpt", "i3d.pt", "valid_ae"))
    checkpoint.save_checkpoint(ckpt, {p: getattr(model, p).state_dict()
                                      for p in checkpoint.AE_PARTS})
    torch.save(nets["i3d_sd"], i3d_file)
    cfg_path = tmp_path / "valid_ae.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    assert valid_ae.main(["--config", str(cfg_path), "--device", "cpu", "--batch_size", "2",
                          "--checkpoint", ckpt, "--i3d_state_dict", i3d_file,
                          "--log_dir", out]) == 0
    res = json.load(open(os.path.join(out, "metrics.json")))
    assert abs(res["psnr"] - jres["valid_psnr"]) <= 1e-2
    assert abs(res["ssim"] - jres["valid_ssim"]) <= 1e-3
    np.testing.assert_allclose(res["fvd"], jres["valid_fvd"], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(res["l1_out_loss"], np.abs(real * 10 - recon * 10).mean(),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(res["l1_warp_loss"], np.abs(real * 10 - warped * 10).mean(),
                               rtol=0, atol=1e-3)
    assert res["i3d_pretrained"] is True and res["fps"] > 0
