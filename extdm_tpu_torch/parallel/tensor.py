"""Tensor parallelism of the DM train step (port of the tensor-parallel
half of extdm_tpu/parallel/mesh.py: ``make_hybrid_mesh``, ``_param_spec`` /
``param_shardings``, ``shard_params`` and ``batch_sharding`` as the DM step
uses them under GSPMD).

- ``make_hybrid_mesh(world, dcn, model)``: the (dcn, data, model) mesh as
  a ``SpatialMesh`` whose data rows are the (dcn, data) pairs flattened:
  rank r = (k data + d) model + m, JAX's ``reshape(dcn, data, model)``
  order, data row k data + d (``batch_sharding``'s ``P(("dcn", "data"))``).
  The rule splits over ``model`` only, never ``dcn``. A GPU reports no
  slice, so the rank order stands in, as JAX's own fallback does. A
  (data, model) mesh is ``make_spatial_mesh(world, data, model)``.
- ``param_plan(state, model)``: JAX's rule (``_param_spec``) on the port's
  tensors. JAX splits a leaf named ``kernel`` or ``embedding`` of ndim >= 2
  and size >= 2048 on its last (output) axis where ``model`` divides it;
  every other leaf is replicated. The plan reads each port tensor's JAX
  leaves through convert.py's key map (``jax_unet_params``, then
  ``unet_arrays`` back): each leaf marked by its decision, the marks
  carried onto the port's layout, so that a Conv3d or Linear weight splits
  on dim 0, a ConvTranspose3d weight (``Upsample``) on dim 1, and the one
  init conv that joins JAX's two raises where its leaves disagree.
- ``shard_params(state, mesh)``: this rank's slices of a state dict.
- ``TensorParallel(unet, optimizer, mesh)``: the storage and the exchanges
  of the tensor-parallel step (``DMTrainer(mesh=...)``).

What it buys is memory: each rank keeps its slice of every ruled weight
and of AdamW's two moments for it (about 1 / model of them: at KTH nearly
every parameter is in a ruled leaf). It buys no speed on one card: the
forward and backward run on whole weights gathered before the step (the
fused kernels take whole weights, as JAX's custom calls take replicated
operands under GSPMD), every rank of a model row computes the same rows,
and the whole gradient is averaged over the world.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from extdm_tpu_torch.parallel.mesh import (DataGroup, _all_reduce_sum, _flat, _unflat,
                                           all_mean, broadcast_module)
from extdm_tpu_torch.parallel.spatial import SpatialMesh, make_spatial_mesh

MIN_SIZE = 2048
RULED_LEAVES = ("kernel", "embedding")


def make_hybrid_mesh(world, dcn: int, model: int = 1) -> SpatialMesh:
    """The (dcn, data, model) mesh of a world of dcn x data x model ranks
    (data = world / (dcn model); every rank calls it)."""
    if dcn < 1 or model < 1 or world.size % (dcn * model):
        raise ValueError(f"{world.size} ranks do not split into dcn {dcn} x model {model}")
    mesh = make_spatial_mesh(world, world.size // model, model)
    mesh.dcn = dcn
    return mesh


def jax_rule(path: str, shape: Tuple[int, ...], model: int, min_size: int = MIN_SIZE) -> bool:
    """JAX's ``_param_spec`` on one leaf: whether the leaf at `path` (its
    last name) of `shape` splits on its last axis over `model` ranks."""
    if model <= 1 or len(shape) < 2 or math.prod(shape) < min_size:
        return False
    if path.rsplit("/", 1)[-1] not in RULED_LEAVES:
        return False
    return shape[-1] % model == 0


def _leaves(tree: Mapping, prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            yield from _leaves(v, path)
        else:
            yield path, v


def _put(tree: Dict, path: str, value) -> None:
    *head, leaf = path.split("/")
    for part in head:
        tree = tree.setdefault(part, {})
    tree[leaf] = value


def _split_axis(key: str, marks: np.ndarray) -> Optional[int]:
    """The axis along which a port tensor's marks vary (its JAX leaves
    split on it), None where every mark is 0 (replicated)."""
    # a broadcast axis (stride 0) holds one value: read its first entry only
    marks = marks[tuple(slice(0, 1) if st == 0 else slice(None) for st in marks.strides)]
    if marks.max() == 0:
        return None
    if marks.min() == 0:
        raise ValueError(f"{key}: its JAX leaves disagree: the rule splits one and replicates "
                         "another, and the port holds them as one tensor")
    axes = [ax for ax in range(marks.ndim) if marks.shape[ax] > 1
            and not np.array_equal(marks.take(0, axis=ax), marks.take(-1, axis=ax))]
    if len(axes) != 1:
        raise ValueError(f"{key}: its split runs along axes {axes}, not one")
    return axes[0]


def param_plan(state: Mapping[str, torch.Tensor], model: int) -> Dict[str, Optional[int]]:
    """JAX's tensor-parallel rule on a ``Unet3D`` state dict (or a module's
    ``state_dict()``; only the shapes are read, meta tensors do): for each
    key the axis its tensor splits on over `model` ranks, None where it is
    replicated."""
    from extdm_tpu_torch import convert  # which imports the models, which import parallel

    if isinstance(state, torch.nn.Module):
        state = state.state_dict()
    zeros = {k: np.broadcast_to(np.float32(0), tuple(v.shape)) for k, v in state.items()}
    marked: Dict = {}
    for path, leaf in _leaves(convert.jax_unet_params(zeros)):
        shape = tuple(leaf.shape)
        mark = (np.arange(1, shape[-1] + 1, dtype=np.float32) if jax_rule(path, shape, model)
                else np.float32(0))
        _put(marked, path, np.broadcast_to(mark, shape))
    back = convert.unet_arrays(marked)
    if set(back) != set(state):
        raise ValueError(f"the key map does not cover the state dict: "
                         f"{sorted(set(back) ^ set(state))[:5]}")
    plan = {}
    for k, v in state.items():
        if tuple(back[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: the key map gives {back[k].shape}, the state {tuple(v.shape)}")
        plan[k] = _split_axis(k, back[k])
    return plan


def _slice(t: torch.Tensor, axis: int, m: int, model: int) -> torch.Tensor:
    n = t.shape[axis] // model
    return t.narrow(axis, m * n, n)


def shard_params(state: Mapping[str, torch.Tensor], mesh: SpatialMesh,
                 plan: Optional[Dict[str, Optional[int]]] = None) -> Dict[str, torch.Tensor]:
    """This rank's part of a state dict: its slice of each tensor the rule
    splits (views), every other tensor whole."""
    plan = plan if plan is not None else param_plan(state, mesh.model)
    return {k: v if plan[k] is None else _slice(v, plan[k], mesh.m, mesh.model)
            for k, v in state.items()}


def resident_bytes(optimizer) -> int:
    """The bytes an optimizer's parameters and state hold (on a
    tensor-parallel rank: its slices, the replicated leaves and their
    moments)."""
    n = sum(p.numel() * p.element_size() for p in optimizer.params)
    for st in optimizer.opt.state.values():
        n += sum(v.numel() * v.element_size() for v in st.values() if torch.is_tensor(v))
    return n


class TensorParallel:
    """The tensor-parallel storage of a UNet and its ``ScheduledOptimizer``
    on a (data, model) or hybrid mesh. At construction the UNet's weights
    are broadcast from world rank 0; each ruled parameter is cut to this
    rank's slice, which takes its place in the optimizer (AdamW's moments
    are then the slice's), and the UNet's own tensor is emptied.

    - ``gather_weights()``: the whole weights from every model rank's
      slices (one all-reduce over the model row, kind "tp_gather"), set as
      the UNet's parameters for a forward and backward.
    - ``reduce_gradients()``: the whole gradient summed over the world and
      divided by its size (kind "grad"): the data rows' mean, the same on
      every rank, so that the copies of a replicated leaf stay
      bit-identical (the model ranks of a row compute their rows apart, and
      kernel 3's GroupNorm atomics need not repeat bit for bit); each
      slice's gradient is cut from it, the whole weights and gradients
      freed. Returns (the whole gradient's norm, whether it is finite).
    - ``state_dict()`` / ``optimizer_state_dict()``: the single process's
      layout, whole tensors and whole moments (collective: every rank
      calls them); ``load_state_dict`` cuts the slices.

    ``mesh.timings``, where set, collects each exchange's ms by kind."""

    def __init__(self, unet: torch.nn.Module, optimizer, mesh: SpatialMesh):
        self.unet, self.optimizer, self.mesh = unet, optimizer, mesh
        world = mesh.world
        self.group = DataGroup(size=world.size, rank=world.rank, world=world)
        params = dict(unet.named_parameters())
        if [id(p) for p in optimizer.params] != [id(p) for p in params.values()]:
            raise ValueError("the optimizer must hold the UNet's parameters, in their order")
        broadcast_module(unet, self.group)
        self.plan = param_plan(unet.state_dict(), mesh.model)
        self.params = params
        self.axes = {n: self.plan[n] for n in params if self.plan[n] is not None}
        self.shapes = {n: tuple(params[n].shape) for n in self.axes}
        local = shard_params({n: p.detach() for n, p in params.items()}, mesh, self.plan)
        self.shards: Dict[str, torch.nn.Parameter] = {}
        swap = {}
        for n in self.axes:
            p = params[n]
            if p.dtype != torch.float32:
                raise ValueError(f"{n}: tensor parallelism keeps float32 weights, not {p.dtype}")
            self.shards[n] = swap[id(p)] = torch.nn.Parameter(local[n].clone())
            p.data = p.data.new_empty(0)
        for g in optimizer.opt.param_groups:
            g["params"] = [swap.get(id(p), p) for p in g["params"]]
        optimizer.params = [p for g in optimizer.opt.param_groups for p in g["params"]]
        self.names = list(params)

    # ------------------------------------------------------------ gathers
    def _gather(self, slices: Dict[str, torch.Tensor], kind: str) -> Dict[str, torch.Tensor]:
        """The whole tensors of `slices` (ruled names -> this rank's
        slices), in one all-reduce of a zero-filled buffer over the model row."""
        M, m = self.mesh.model, self.mesh.m
        sizes = [math.prod(self.shapes[n]) for n in slices]
        dev = next(iter(slices.values())).device if slices else self.mesh.world.device
        buf = torch.zeros(sum(sizes), dtype=torch.float32, device=dev)
        out, at = {}, 0
        for (n, s), size in zip(slices.items(), sizes):
            whole = buf[at:at + size].view(self.shapes[n])
            _slice(whole, self.axes[n], m, M).copy_(s.detach())
            out[n] = whole
            at += size
        self.mesh.sum_over_model(buf, kind)
        return out

    def gather_weights(self) -> None:
        for n, whole in self._gather(self.shards, "tp_gather").items():
            self.params[n].data = whole

    def reduce_gradients(self) -> Tuple[torch.Tensor, bool]:
        params = [self.params[n] for n in self.names]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        buf = _flat(grads)
        with self._timed():
            _all_reduce_sum(buf, self.group, "grad")
        buf /= self.group.size
        whole = _unflat(buf, grads)
        norm = torch.sqrt(sum((g ** 2).sum() for g in whole))
        finite = bool(torch.isfinite(buf).all())
        M, m = self.mesh.model, self.mesh.m
        for n, g, p in zip(self.names, whole, params):
            if n in self.axes:
                self.shards[n].grad = _slice(g, self.axes[n], m, M).clone()
                p.grad = None
                p.data = p.data.new_empty(0)
            else:
                p.grad.copy_(g)
        return norm, finite

    def mean_aux(self, aux: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The step's aux averaged over the world (kind "aux")."""
        with self._timed():
            return all_mean(aux, self.group)

    @contextlib.contextmanager
    def _timed(self):
        """The world group's collectives timed into ``mesh.timings``."""
        self.group.timings = self.mesh.timings
        try:
            yield
        finally:
            self.group.timings = None

    # --------------------------------------------------------- checkpoints
    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The UNet's state dict with every tensor whole (collective)."""
        whole = self._gather(self.shards, "tp_gather")
        return {k: whole[k] if k in whole else v for k, v in self.unet.state_dict().items()}

    def _ruled_index(self) -> Dict[int, str]:
        return {i: n for i, n in enumerate(self.names) if n in self.axes}

    def optimizer_state_dict(self) -> dict:
        """``ScheduledOptimizer.state_dict()`` as the single process holds
        it: the ruled leaves' moments whole (collective)."""
        sd = self.optimizer.state_dict()
        ruled = {i: n for i, n in self._ruled_index().items() if i in sd["state"]}
        state = {i: dict(st) for i, st in sd["state"].items()}
        for key in ("exp_avg", "exp_avg_sq"):
            whole = self._gather({n: sd["state"][i][key] for i, n in ruled.items()}, "tp_gather")
            for i, n in ruled.items():
                state[i][key] = whole[n]
        return {**sd, "state": state}

    def load_state_dict(self, weights: Mapping[str, torch.Tensor],
                        optimizer_state: Optional[dict] = None) -> None:
        """Whole weights (and the single process's optimizer state) into
        this rank's slices and replicated leaves."""
        M, m = self.mesh.model, self.mesh.m
        local = shard_params({n: weights[n] for n in self.names}, self.mesh, self.plan)
        with torch.no_grad():
            for n in self.names:
                (self.shards[n] if n in self.axes else self.params[n]).copy_(local[n])
        if optimizer_state is None:
            return
        state = {i: dict(st) for i, st in optimizer_state["state"].items()}
        for i, n in self._ruled_index().items():
            if i in state:
                for key in ("exp_avg", "exp_avg_sq"):
                    state[i][key] = _slice(state[i][key], self.axes[n], m, M)
        self.optimizer.load_state_dict({**optimizer_state, "state": state})
