"""Stage-2 (diffusion) trainer (port of extdm_tpu/train/dm_trainer.py).

One step: frozen-LFAE encode -> q_sample -> UNet forward and backward ->
AdamW on the UNet's float32 parameters, with the MultiStepLR schedule
stepped per update. The epsilon loss is the only gradient source; the LFAE
gets none.

Data parallel (JAX ``shard_mapped_train_step``, dm_trainer.py:115-153):
given a ``parallel.DataGroup`` of several ranks, each rank takes its rows
of the global batch and draws t and noise from its own generator; after
the backward one all-reduce averages the gradients before AdamW (so every
rank applies the same update, and the nan guard skips on all ranks or on
none), the aux is averaged and grad_norm is that of the averaged
gradients. An explicit all-reduce, not a DistributedDataParallel wrapper:
the UNet keeps its state-dict keys.

Tensor parallel (JAX ``jax.jit(train_step)`` on a (data, model) or
(dcn, data, model) mesh with ``shard_params``): given a
``parallel.SpatialMesh`` (``make_spatial_mesh`` or ``make_hybrid_mesh``),
each rank stores its slice of every weight JAX's rule splits, and AdamW's
moments for that slice (``parallel.TensorParallel``). The ranks of one
model row take that data row's rows and draw from the row's generator
(``rank_generator(generator, row)``: JAX's batch spec is over the data
axes only, so its model ranks see the same rows); before the forward the
slices are gathered into whole weights, after the backward the whole
gradient is averaged over the world, grad_norm is its norm, the nan
guard its verdict, and each rank updates its slices and its replicated
leaves. What it buys is the memory of the ruled weights and moments per
rank, not speed: on one card every rank of a row computes the whole step.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

import torch

from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusion
from extdm_tpu_torch.parallel.mesh import (DataGroup, all_mean, average_gradients,
                                           broadcast_module, rank_generator)
from extdm_tpu_torch.parallel.tensor import TensorParallel
from extdm_tpu_torch.train.lr_schedule import ScheduledOptimizer, multi_step
from extdm_tpu_torch.utils.profiler import span


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
    """``DMTrainer(fd, make_optimizer(fd.unet.parameters(), ...), group)``:
    with a data group of several ranks the UNet's weights are broadcast from
    its rank 0 and each step is data parallel. ``mesh=`` (a
    ``parallel.SpatialMesh``; no group) makes the step tensor parallel:
    ``self.tp`` holds the slices (``parallel.TensorParallel``)."""

    def __init__(self, fd: FlowDiffusion, optimizer: ScheduledOptimizer,
                 group: Optional[DataGroup] = None, mesh=None):
        self.fd = fd
        self.optimizer = optimizer
        self.group = group if group is not None and group.parallel else None
        if self.group is not None and mesh is not None:
            raise ValueError("a step is data parallel over a group or tensor parallel over a "
                             "mesh, not both")
        self.tp = TensorParallel(fd.unet, optimizer, mesh) if mesh is not None else None
        if self.group is not None:
            broadcast_module(fd.unet, self.group)

    @span("train.step")
    def train_step(self, generator: torch.Generator, video: torch.Tensor,
                   t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One update from a (B, tc+tp, H, W, C) batch in [0, 1], or raw
        integer video in the stored layout. `t` and `noise` replace the draws
        from `generator`. Returns aux with the loss and grad_norm (the global
        L2 norm of the UNet gradients), as tensors on the device. Data
        parallel, `video`, `t` and `noise` are this rank's rows, the draws
        come from ``rank_generator(generator, rank)``, and the gradients
        and aux are averaged over the ranks."""
        video = canonicalize_video(video.to(self.fd.device))
        if self.tp is not None:
            return self._tp_step(generator, video, t, noise)
        if self.group is not None:
            generator = rank_generator(generator, self.group.rank)
        self.optimizer.zero_grad()
        with span("train.forward"):
            loss, aux = self.fd.loss(generator, video, t=t, noise=noise)
        with span("train.backward"):
            loss.backward()
        if self.group is not None:
            with span("train.reduce"):
                average_gradients(self.optimizer.params, self.group)
                aux = all_mean(aux, self.group)
        with span("train.optimizer"):
            aux["grad_norm"] = global_norm(p.grad for p in self.optimizer.params
                                           if p.grad is not None)
            self.optimizer.step()
        return aux

    def _tp_step(self, generator, video, t, noise) -> Dict[str, torch.Tensor]:
        """The tensor-parallel step: `video`, `t` and `noise` are this
        rank's data row's rows."""
        tp = self.tp
        self.optimizer.zero_grad()
        tp.gather_weights()
        with span("train.forward"):
            loss, aux = self.fd.loss(rank_generator(generator, tp.mesh.d), video, t=t,
                                     noise=noise)
        with span("train.backward"):
            loss.backward()
        with span("train.reduce"):  # the gradients' norm and nan verdict come with them
            grad_norm, finite = tp.reduce_gradients()
            aux = tp.mean_aux(aux)
        aux["grad_norm"] = grad_norm
        with span("train.optimizer"):
            self.optimizer.step(finite=finite)
        return aux
