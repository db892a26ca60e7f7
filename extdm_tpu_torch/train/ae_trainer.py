"""Stage-1 (LFAE) trainer (port of extdm_tpu/train/ae_trainer.py).

One step: device augmentation of a raw {source, driving} pair batch ->
``ReconstructionModel`` forward with BatchNorm in train mode (region and bg
predictors, generator in ``full`` mode, perceptual, equivariance and
reconstruction losses) -> backward through every warp -> Adam(0.5, 0.999)
over all modules (and, optionally, the reference's learnable scalar loss
weights), with the MultiStepLR schedule stepped per update.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import torch

from extdm_tpu_torch.models.dm.flow_diffusion import resolve_device
from extdm_tpu_torch.models.lfae.recon_model import ReconstructionModel
from extdm_tpu_torch.models.lfae.transform import TPSTransform, random_tps
from extdm_tpu_torch.train.device_augment import AugmentParams, prepare_batch, sample_augment
from extdm_tpu_torch.train.lr_schedule import ScheduledOptimizer, multi_step

LOSS_KEYS = ("perceptual", "equivariance_shift", "equivariance_affine", "reconstruction")
OptimizerFactory = Callable[[Iterable[torch.nn.Parameter]], ScheduledOptimizer]


def make_optimizer(lr: float, milestones: Sequence[int], gamma: float,
                   nan_guard: int = 0) -> OptimizerFactory:
    """Adam (betas 0.5, 0.999, eps 1e-8) with the learning rate
    multi_step(update count) and the nan guard of ``ScheduledOptimizer``, as
    optax.adam(multi_step(...)) (optionally under apply_if_finite). Returns a
    factory over the parameters: the trainer adds its learnable loss weights
    to the model's before the optimizer state exists, as the JAX trainer
    inits the optax state over (params, loss weights)."""
    schedule = multi_step(lr, milestones, gamma)

    def build(params: Iterable[torch.nn.Parameter]) -> ScheduledOptimizer:
        opt = torch.optim.Adam(list(params), lr=schedule(0), betas=(0.5, 0.999), eps=1e-8)
        return ScheduledOptimizer(opt, schedule, nan_guard)

    return build


def _to(obj, device):
    """Tensors (inside tuples and dicts, None kept) moved to `device`."""
    if torch.is_tensor(obj):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _to(v, device) for k, v in obj.items()}
    if isinstance(obj, tuple):
        vals = [_to(v, device) for v in obj]
        return type(obj)(*vals) if hasattr(obj, "_fields") else tuple(vals)
    return obj


class AETrainer:
    """``AETrainer(model, make_optimizer(...), learnable_loss_weights,
    device_augment)`` moves the model to `device` (a CUDA device needs a
    card; the CPU runs only when asked) in train mode and builds the
    optimizer over its parameters and the loss weights. ``device_augment``
    is the config's {"flip_param": ..., "jitter_param": ...} (raw uint8
    pairs are then augmented on the device) or None (batches are only
    canonicalized)."""

    def __init__(self, model: ReconstructionModel, optimizer: OptimizerFactory,
                 learnable_loss_weights: bool = False, device_augment: Optional[dict] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).train()
        self.loss_weights = None
        params = list(self.model.parameters())
        if learnable_loss_weights:
            self.loss_weights = {k: torch.nn.Parameter(torch.ones((), device=self.device))
                                 for k in LOSS_KEYS}
            params += list(self.loss_weights.values())
        self.optimizer = optimizer(params)
        self.device_augment = device_augment

    def total_loss(self, losses: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Sum of the losses, each times its learnable weight where there is one."""
        lw = self.loss_weights or {}
        return sum(lw.get(k, 1.0) * v for k, v in losses.items())

    def loss(self, generator: Optional[torch.Generator], batch: Dict[str, torch.Tensor],
             tps: Optional[TPSTransform] = None, augment: Optional[AugmentParams] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total, losses) of one batch, differentiable in every parameter.
        `augment` and `tps` replace the draws from `generator` (augmentation
        first, then the TPS transform)."""
        src, drv = batch["source"].to(self.device), batch["driving"].to(self.device)
        B, hw = src.shape[0], tuple(src.shape[1:3])
        if augment is None and self.device_augment is not None:
            augment = sample_augment(generator, B, hw, self.device, **self.device_augment)
        src, drv = prepare_batch(src, drv, _to(augment, self.device))
        if tps is None and self.model.uses_tps:
            tps = random_tps(generator, B, device=self.device, **self.model.transform_params)
        losses, _ = self.model(src, drv, _to(tps, self.device))
        return self.total_loss(losses), losses

    def train_step(self, generator: Optional[torch.Generator], batch: Dict[str, torch.Tensor],
                   tps: Optional[TPSTransform] = None,
                   augment: Optional[AugmentParams] = None) -> Dict[str, torch.Tensor]:
        """One update from a {source, driving} batch (raw integer stored
        layout or float (B, H, W, 3) in [0, 1]). Returns aux with every loss
        and loss_total, as tensors on the device."""
        self.optimizer.zero_grad()
        total, losses = self.loss(generator, batch, tps, augment)
        total.backward()
        self.optimizer.step()
        aux = {k: v.detach() for k, v in losses.items()}
        aux["loss_total"] = total.detach()
        return aux
