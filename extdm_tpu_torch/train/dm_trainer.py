"""Stage-2 (diffusion) trainer (port of extdm_tpu/train/dm_trainer.py).

One step: frozen-LFAE encode -> q_sample -> UNet forward and backward ->
AdamW on the UNet's float32 parameters, with the MultiStepLR schedule
stepped per update. The epsilon loss is the only gradient source; the LFAE
gets none.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

import torch

from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusion
from extdm_tpu_torch.train.lr_schedule import ScheduledOptimizer, multi_step


def canonicalize_video(video: torch.Tensor) -> torch.Tensor:
    """Integer video -> float32 / 255; (B, T, H, W) gray gets a channel axis;
    one channel is repeated to 3. Float input passes through."""
    if not torch.is_floating_point(video):
        video = video.float() / 255.0
    if video.ndim == 4:
        video = video[..., None]
    if video.shape[-1] == 1:
        video = video.repeat_interleave(3, dim=-1)
    return video


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """L2 norm of all gradients together (optax.global_norm)."""
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float, milestones: Sequence[int],
                   gamma: float, weight_decay: float = 0.01,
                   nan_guard: int = 0) -> ScheduledOptimizer:
    """AdamW (betas 0.9, 0.999, eps 1e-8, decoupled weight decay on every
    parameter) over `params` (the UNet's) with the learning rate
    multi_step(update count), as optax's adamw(multi_step(...)). optax
    updates p - lr (m^ / (sqrt(v^) + eps) + wd p), torch's AdamW
    p (1 - lr wd) - lr m^ / (sqrt(v^) + eps): the same update."""
    schedule = multi_step(lr, milestones, gamma)
    opt = torch.optim.AdamW(list(params), lr=schedule(0), betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    return ScheduledOptimizer(opt, schedule, nan_guard)


class DMTrainer:
    def __init__(self, fd: FlowDiffusion, optimizer: ScheduledOptimizer):
        self.fd = fd
        self.optimizer = optimizer

    def train_step(self, generator: torch.Generator, video: torch.Tensor,
                   t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One update from a (B, tc+tp, H, W, C) batch in [0, 1], or raw
        integer video in the stored layout. `t` and `noise` replace the draws
        from `generator`. Returns aux with the loss and grad_norm (the global
        L2 norm of the UNet gradients), as tensors on the device."""
        video = canonicalize_video(video.to(self.fd.device))
        self.optimizer.zero_grad()
        loss, aux = self.fd.loss(generator, video, t=t, noise=noise)
        loss.backward()
        aux["grad_norm"] = global_norm(p.grad for p in self.optimizer.params
                                       if p.grad is not None)
        self.optimizer.step()
        return aux
