"""The training jobs' checkpoints (extdm_tpu_torch.train.checkpoint) on the
CPU, at tiny sizes: the DM and AE payloads round-trip every parameter,
Adam(W)'s moments and step, the schedule's update count, the nan guard's
count, the loss weights, the example and the step, exactly; a write that
fails midway leaves the old file whole; start_step_from_example, gate_best
and select_gate_metric equal the JAX package's on a grid of inputs;
eval/valid_dm.load_weights reads both jobs' checkpoints (a float32 AE
checkpoint into a bf16 LFAE, cast)."""
import os

import pytest
import torch

from extdm_tpu.train import checkpoint as jckpt
from extdm_tpu_torch.eval import valid_dm
from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusion, FlowDiffusionConfig
from extdm_tpu_torch.models.lfae.recon_model import ReconstructionModel
from extdm_tpu_torch.train import ae_trainer, checkpoint, dm_trainer
from torch_port_helpers import tiny_flow_params

DM_CFG = dict(cond_frames=2, pred_frames=2, frame_shape=32, timesteps=1000, sampling_timesteps=2,
              dim=16, dim_mults=(1, 2), attn_heads=2, attn_dim_head=8)


def tiny_ae_kwargs():
    fp = tiny_flow_params()
    return dict(region_predictor_cfg=dict(fp["region_predictor_params"], estimate_affine=True),
                bg_predictor_cfg=fp["bg_predictor_params"],
                generator_cfg=dict(fp["generator_params"], revert_axis_swap=True),
                num_regions=3, num_channels=3, scales=(1.0, 0.5),
                loss_weights=dict(perceptual=[1, 1, 1, 1, 1], equivariance_shift=10,
                                  equivariance_affine=10, reconstruction=10),
                transform_params=dict(sigma_affine=0.05, sigma_tps=0.005, points_tps=5))


def _nan_step(opt):
    """One skipped (non-finite) update: the guard's count goes to 1."""
    for p in opt.params:
        p.grad = torch.full_like(p, float("nan"))
    assert opt.step() is False


def dm_run(seed=0):
    fd = FlowDiffusion(FlowDiffusionConfig(flow_params=tiny_flow_params(), **DM_CFG),
                       device="cpu", seed=seed)
    opt = dm_trainer.make_optimizer(fd.unet.parameters(), 1e-3, (1,), 0.5, nan_guard=2)
    return fd, dm_trainer.DMTrainer(fd, opt)


def ae_run(seed=0):
    torch.manual_seed(seed)
    return ae_trainer.AETrainer(ReconstructionModel(**tiny_ae_kwargs()),
                                ae_trainer.make_optimizer(1e-3, (1,), 0.5, nan_guard=2),
                                learnable_loss_weights=True, device="cpu")


@pytest.fixture(scope="module")
def trained():
    """{kind: (trainer, payload)}: a trainer after one update and one skipped
    step, and its payload at step 7 of batch 3 (example 21)."""
    return {kind: _trained(kind) for kind in ("dm", "ae")}


def _trained(kind):
    g = torch.Generator().manual_seed(1)
    if kind == "dm":
        fd, trainer = dm_run()
        trainer.train_step(g, torch.rand(2, 4, 32, 32, 3, generator=g))
        _nan_step(trainer.optimizer)
        return trainer, checkpoint.dm_payload(fd.unet, trainer.optimizer, 7, 21, 1)
    trainer = ae_run()
    trainer.train_step(g, {k: torch.rand(2, 32, 32, 3, generator=g)
                           for k in ("source", "driving")})
    _nan_step(trainer.optimizer)
    return trainer, checkpoint.ae_payload(trainer.model, trainer.optimizer, 7, 21, 1,
                                          trainer.loss_weights)


def _state(trainer):
    module = trainer.fd.unet if hasattr(trainer, "fd") else trainer.model
    opt = trainer.optimizer
    moments = {i: {k: v.clone() for k, v in opt.opt.state[p].items()}
               for i, p in enumerate(opt.params)}
    lw = {k: w.item() for k, w in (getattr(trainer, "loss_weights", None) or {}).items()}
    return ({k: v.clone() for k, v in module.state_dict().items()}, moments,
            opt.count, opt.notfinite_count, lw)


@pytest.mark.parametrize("kind", ["dm", "ae"])
def test_payload_round_trip(kind, trained, tmp_path):
    trainer, payload = trained[kind]
    path = str(tmp_path / "x.ckpt")
    checkpoint.save_checkpoint(path, payload)
    ckpt = checkpoint.load_checkpoint(path)
    keys = {"example", "epoch", "step", "optimizer"} | (
        {"diffusion"} if kind == "dm" else
        {"generator", "bg_predictor", "region_predictor", "vgg", "loss_weights"})
    assert set(ckpt) == keys and (ckpt["example"], ckpt["step"], ckpt["epoch"]) == (21, 7, 1)
    assert ckpt["optimizer"]["count"] == 1 and ckpt["optimizer"]["notfinite_count"] == 1
    fresh = dm_run(seed=5)[1] if kind == "dm" else ae_run(seed=5)
    if kind == "dm":
        assert all(k.startswith("denoise_fn.") for k in ckpt["diffusion"])
        checkpoint.restore_dm(ckpt, fresh.fd.unet, fresh.optimizer)
    else:
        checkpoint.restore_ae(ckpt, fresh.model, fresh.optimizer, fresh.loss_weights)
    want, got = _state(trainer), _state(fresh)
    for a, b in zip(want[0].values(), got[0].values()):
        assert torch.equal(a, b)
    assert want[0].keys() == got[0].keys()
    assert want[1].keys() == got[1].keys()
    for i in want[1]:
        assert want[1][i].keys() == got[1][i].keys() == {"step", "exp_avg", "exp_avg_sq"}
        for k in want[1][i]:
            assert torch.equal(want[1][i][k], got[1][i][k]), (i, k)
    assert want[2:] == got[2:]


def test_failed_write_leaves_the_old_file_whole(tmp_path, monkeypatch):
    path = str(tmp_path / "flowdiff.ckpt")
    checkpoint.save_checkpoint(path, {"example": 4, "w": torch.arange(5.0)})

    def broken_save(obj, f):
        with open(f, "wb") as fh:
            fh.write(b"half a checkpoint")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken_save)
    with pytest.raises(OSError, match="disk full"):
        checkpoint.save_checkpoint(path, {"example": 8, "w": torch.zeros(5)})
    monkeypatch.undo()
    old = checkpoint.load_checkpoint(path)
    assert old["example"] == 4 and torch.equal(old["w"], torch.arange(5.0))


def test_step_and_gate_helpers_match_jax(tmp_path):
    for example in (0, 1, 7, 8, 9, 63, 64, 65, 1000):
        for batch in (1, 2, 3, 8, 64):
            assert (checkpoint.start_step_from_example(example, batch)
                    == jckpt.start_step_from_example(example, batch))
    src = tmp_path / "RegionMM.ckpt"
    src.write_bytes(b"checkpoint bytes")
    for i, metric in enumerate((0.5, 12.3456, 1e-4, 123.0)):
        a, b = tmp_path / f"port{i}", tmp_path / f"jax{i}"
        got = checkpoint.gate_best(str(src), str(a), metric, "RegionMM_ssim")
        want = jckpt.gate_best(str(src), str(b), metric, "RegionMM_ssim")
        assert os.path.basename(got) == os.path.basename(want)
        assert open(got, "rb").read() == b"checkpoint bytes"
    for pre in (0.0, 1.0, False, True):
        for fvd in (0.0, 3.5, 120.25):
            for ssim in (0.1, 0.75):
                vm = {"i3d_pretrained": pre, "valid_fvd": fvd, "valid_ssim": ssim}
                assert checkpoint.select_gate_metric(vm) == jckpt.select_gate_metric(vm)


def test_load_weights_reads_both_jobs_checkpoints(trained, tmp_path):
    """The DM job's payload into the UNet; the AE job's (float32) into a
    bf16 LFAE, cast; the optimizer, vgg and loss-weight entries unread."""
    dm_trainer_, dm_payload = trained["dm"]
    ae_trainer_, ae_payload = trained["ae"]
    dm_path, ae_path = str(tmp_path / "flowdiff.ckpt"), str(tmp_path / "RegionMM.ckpt")
    checkpoint.save_checkpoint(dm_path, dm_payload)
    checkpoint.save_checkpoint(ae_path, ae_payload)
    cfg = FlowDiffusionConfig(flow_params=tiny_flow_params(), dtype=torch.bfloat16, **DM_CFG)
    fd = FlowDiffusion(cfg, device="cpu", seed=9)
    valid_dm.load_weights(fd, ae_path, dm_path)
    for name, v in fd.unet.state_dict().items():
        assert torch.equal(v, dm_trainer_.fd.unet.state_dict()[name]), name
    want = ae_trainer_.model.state_dict()
    lfae = fd.lfae.state_dict()
    assert set(lfae) == {k for k in want if not k.startswith("vgg.")}
    for name, v in lfae.items():
        assert v.dtype == (torch.bfloat16 if want[name].is_floating_point() else want[name].dtype)
        assert torch.equal(v, want[name].to(v.dtype)), name
