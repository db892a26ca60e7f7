"""Checkpoints of the two training jobs (port of extdm_tpu/train/checkpoint.py),
written with ``torch.save`` in the reference layout (SURVEY §5).

- DM: {"example", "epoch", "step", "diffusion", "optimizer"}. "diffusion"
  is the GaussianDiffusion state dict of the reference: the UNet's under
  ``denoise_fn.`` keys.
- AE: {"example", "epoch", "step", "generator", "bg_predictor",
  "region_predictor", "optimizer"}, with "vgg" (this package, as the JAX
  package, trains the perceptual loss's VGG19) and, under
  --learnable_loss_weights, "loss_weights".

"optimizer" is ``ScheduledOptimizer.state_dict()``: the torch optimizer's
state dict with the schedule's update count and the nan guard's count, so
that a resumed run continues the schedule and the guard. Files are written
to a tmp file and moved into place with ``os.replace``: a crash never leaves
a half-written checkpoint. In a data-parallel job rank 0 writes and every
rank reads (``train/job.py``: the others wait at a barrier until the file
is in place); a payload holds the global batch's example count and no rank
or world size, so a checkpoint written at one world size resumes at any
other.
"""
from __future__ import annotations

import math
import os
import shutil
from typing import Any, Dict, Optional

import torch

from extdm_tpu_torch.train.lr_schedule import ScheduledOptimizer

AE_PARTS = ("generator", "bg_predictor", "region_predictor")


def save_checkpoint(path: str, payload: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=True)


def start_step_from_example(example: int, batch_size: int) -> int:
    """ref: scripts/DM/train.py:111-116."""
    return int(math.ceil(example / batch_size))


def gate_best(path: str, best_dir: str, metric: float, prefix: str) -> str:
    """Copy `path` to {best_dir}/{prefix}_best_{metric:.3f}.ckpt; returns the copy."""
    os.makedirs(best_dir, exist_ok=True)
    dst = os.path.join(best_dir, f"{prefix}_best_{metric:.3f}.ckpt")
    shutil.copyfile(path, dst)
    return dst


def select_gate_metric(vm: Dict[str, Any]) -> tuple:
    """(sort value, display value, name) of the best-checkpoint criterion of a
    validation dict: FVD (lower is better) with a pretrained I3D; otherwise
    SSIM, negated for the sort (a random I3D maps every clip to nearly the
    same features, so its FVD is ~0 for every checkpoint)."""
    if vm.get("i3d_pretrained"):
        return float(vm["valid_fvd"]), float(vm["valid_fvd"]), "fvd"
    return -float(vm["valid_ssim"]), float(vm["valid_ssim"]), "ssim"


def _snapshot(v: torch.Tensor) -> torch.Tensor:
    """A host copy of `v` (a copy also on the CPU: a payload held in memory
    must not follow the optimizer's in-place updates)."""
    return v.detach().to("cpu", copy=True)


def _cpu(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: _snapshot(v) for k, v in state.items()}


def dm_payload(unet: torch.nn.Module, optimizer: ScheduledOptimizer, step: int, example: int,
               epoch: int = 0, tp=None) -> Dict[str, Any]:
    """The DM payload. With `tp` (a tensor-parallel step's
    ``parallel.TensorParallel``; every rank calls it, rank 0 writes) the
    single process's payload: whole weights and whole moments, gathered."""
    weights = unet.state_dict() if tp is None else tp.state_dict()
    return {"example": int(example), "epoch": int(epoch), "step": int(step),
            "diffusion": {f"denoise_fn.{k}": v for k, v in _cpu(weights).items()},
            "optimizer": _cpu_state(optimizer.state_dict() if tp is None
                                    else tp.optimizer_state_dict())}


def _cpu_state(sd: Dict[str, Any]) -> Dict[str, Any]:
    return {**sd, "state": {i: {k: _snapshot(v) if torch.is_tensor(v) else v
                                for k, v in st.items()} for i, st in sd["state"].items()}}


def restore_dm(ckpt: Dict[str, Any], unet: torch.nn.Module,
               optimizer: Optional[ScheduledOptimizer] = None, tp=None) -> None:
    """The UNet's weights (and the optimizer's state) from a DM payload;
    with `tp`, this rank's slices of them."""
    weights = {k[len("denoise_fn."):]: v for k, v in ckpt["diffusion"].items()
               if k.startswith("denoise_fn.")}
    if optimizer is not None and "optimizer" not in ckpt:
        raise ValueError("the DM checkpoint holds weights only (no optimizer state): it "
                         "loads for sampling, not to resume training")
    opt_state = ckpt["optimizer"] if optimizer is not None else None
    if tp is not None:
        tp.load_state_dict(weights, opt_state)
        return
    unet.load_state_dict(weights)
    if opt_state is not None:
        optimizer.load_state_dict(opt_state)


def ae_payload(model: torch.nn.Module, optimizer: ScheduledOptimizer, step: int, example: int,
               epoch: int = 0, loss_weights: Optional[Dict[str, torch.Tensor]] = None
               ) -> Dict[str, Any]:
    out = {"example": int(example), "epoch": int(epoch), "step": int(step)}
    for part in AE_PARTS:
        out[part] = _cpu(getattr(model, part).state_dict())
    if getattr(model, "vgg", None) is not None:
        out["vgg"] = _cpu(model.vgg.state_dict())
    out["optimizer"] = optimizer.state_dict()
    if loss_weights is not None:
        out["loss_weights"] = {k: w.detach().cpu() for k, w in loss_weights.items()}
    return out


def restore_ae(ckpt: Dict[str, Any], model: torch.nn.Module,
               optimizer: Optional[ScheduledOptimizer] = None,
               loss_weights: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """The model's modules (the optimizer's state, the loss weights) from an
    AE payload."""
    for part in AE_PARTS:
        getattr(model, part).load_state_dict(ckpt[part])
    if getattr(model, "vgg", None) is not None and "vgg" in ckpt:
        model.vgg.load_state_dict(ckpt["vgg"])
    if loss_weights is not None:
        with torch.no_grad():
            for k, w in loss_weights.items():
                w.copy_(ckpt["loss_weights"][k])
    if optimizer is not None:
        optimizer.load_state_dict(ckpt["optimizer"])
