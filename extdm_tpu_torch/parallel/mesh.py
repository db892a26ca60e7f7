"""Data parallelism over ``torch.distributed`` (port of the data half of
extdm_tpu/parallel/mesh.py:20-111): one process per rank, launched by
``torchrun`` or ``torch.multiprocessing.spawn``.

- ``init_data_group(backend, device)`` joins the world (torchrun's
  environment, or the rank and world given) and puts the process on its
  card. The backend is the caller's: ``nccl`` serves one rank per card,
  ``gloo`` serves CPU tensors and CUDA tensors (staged through the host),
  so several ranks may share one card over gloo. Nothing switches backend
  or device on a failure: a mismatch raises.
- ``make_data_group(batch_size, world)``: the ranks over which the global
  batch is split, the most that divide it (``make_data_mesh``'s rule), a
  process group of their own. Ranks beyond them join no collective and
  wait at a world barrier at the end (``train/job.py`` ``finish``).
- ``shard_batch`` (a rank's rows of the global batch), ``all_mean`` (a
  dict of tensors averaged over the ranks), ``gather_batch`` (the global
  batch from each rank's rows), ``all_mean_autograd`` (an average whose
  backward averages the cotangent: SyncBN's statistics and the AE's
  losses) and ``average_gradients`` (one all-reduce of every gradient).

The global batch is what one process would load; rank r of n takes rows
[r B / n, (r + 1) B / n). Rank r's draws come from
``rank_generator(generator, r)``: rank 0 keeps the generator itself, so a
world of one draws what a single process draws (JAX folds the rank into
the key, ``fold_in(key, axis_index)``).
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Any, Dict, Iterable, List, Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
# The world group carries only the barrier at a run's end, where ranks
# outside the data group wait for the whole run; the data group's
# collectives keep torch's default timeout.
WORLD_TIMEOUT = timedelta(days=7)


@dataclass(frozen=True)
class World:
    """This process's place in the world: its rank, the world's size, its
    local rank on the host, the device it computes on and the backend."""
    rank: int
    size: int
    local_rank: int
    device: torch.device
    backend: str


def _env_int(name: str, given: Optional[int], default: int) -> int:
    if given is not None:
        return int(given)
    return int(os.environ.get(name, default))


def init_data_group(backend: str, device="cuda", rank: Optional[int] = None,
                    world_size: Optional[int] = None, local_rank: Optional[int] = None,
                    init_method: Optional[str] = None) -> World:
    """Join the world of ``world_size`` processes as ``rank`` (default:
    torchrun's RANK, WORLD_SIZE and LOCAL_RANK; a world of one without
    them) over ``backend`` ("nccl" or "gloo"), and put this process on its
    device: on "cuda", card LOCAL_RANK (``torch.cuda.set_device``: the
    kernels launch on the current card), or LOCAL_RANK modulo the cards
    where gloo lets ranks share one; "cpu" needs gloo. ``init_method``
    defaults to ``env://`` (torchrun's MASTER_ADDR and MASTER_PORT). A
    world of one initialises no process group."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    rank = _env_int("RANK", rank, 0)
    size = _env_int("WORLD_SIZE", world_size, 1)
    local = _env_int("LOCAL_RANK", local_rank, rank)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: device {device!r} asked for, but no CUDA device "
                               "is available")
        cards = torch.cuda.device_count()
        if backend == "nccl" and local >= cards:
            raise RuntimeError(f"nccl serves one rank per card: local rank {local} on a host "
                               f"of {cards} card(s); launch at most {cards} ranks a host, or "
                               "pass backend='gloo' to let ranks share a card")
        dev = torch.device("cuda", local % cards)
        torch.cuda.set_device(dev)
    elif dev.type == "cpu":
        if backend != "gloo":
            raise RuntimeError(f"backend {backend!r} takes no CPU tensors; the CPU needs gloo")
    else:
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    if size > 1 and not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                world_size=size, timeout=WORLD_TIMEOUT)
    return World(rank=rank, size=size, local_rank=local, device=dev, backend=backend)


@dataclass(eq=False)
class DataGroup:
    """The ranks a global batch is split over: ``size`` ranks, this
    process's ``rank`` among them (-1: not a member), their process
    ``group`` (None for one rank alone). ``timings``, where a caller sets
    it to a dict, collects the milliseconds of each collective by kind
    ("grad", "bn", "loss", "aux", "gather"), each bracketed by a device
    sync."""
    size: int
    rank: int
    world: World
    group: Any = None
    timings: Optional[Dict[str, List[float]]] = field(default=None, repr=False)

    @property
    def member(self) -> bool:
        return self.rank >= 0

    @property
    def parallel(self) -> bool:
        """More than one rank: the steps reduce across ranks."""
        return self.size > 1 and self.member

    def rows(self, batch: int) -> slice:
        """This rank's rows of a global batch of `batch`."""
        if batch % self.size:
            raise ValueError(f"batch {batch} does not split over {self.size} ranks")
        per = batch // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def barrier(self) -> None:
        if self.parallel:
            dist.barrier(group=self.group)


def data_ranks(batch_size: int, world_size: int) -> int:
    """The most ranks, at most ``world_size``, that divide the batch."""
    n = min(world_size, max(1, batch_size))
    while batch_size % n:
        n -= 1
    return n


def make_data_group(batch_size: int, world: World) -> DataGroup:
    """The data group of a global batch of ``batch_size`` (every rank of
    the world calls it: a subgroup is made collectively). Prints, as
    ``make_data_mesh`` does, when the batch leaves ranks out."""
    n = data_ranks(batch_size, world.size)
    if n < world.size:
        print(f"data mesh: batch {batch_size} not divisible by {world.size} devices; using {n}")
    group = dist.new_group(list(range(n))) if world.size > 1 else None
    return DataGroup(size=n, rank=world.rank if world.rank < n else -1, world=world,
                     group=group)


def rank_generator(generator: Optional[torch.Generator], rank: int
                   ) -> Optional[torch.Generator]:
    """Rank r's generator from a step's: rank 0 keeps it, rank r > 0 gets
    one seeded from (its initial seed, r), on the same device."""
    if generator is None or rank <= 0:
        return generator
    seed = (generator.initial_seed() * 1_000_003 + 7_919 * rank) % (2 ** 63)
    return torch.Generator(device=generator.device).manual_seed(seed)


# ------------------------------------------------------------- collectives
class _Timed:
    def __init__(self, group: DataGroup, kind: str, device: torch.device):
        self.group, self.kind, self.device = group, kind, device

    def __enter__(self):
        if self.group.timings is not None:
            _sync(self.device)
            self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if self.group.timings is not None and exc[0] is None:
            _sync(self.device)
            self.group.timings.setdefault(self.kind, []).append(
                (time.perf_counter() - self.t0) * 1e3)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _all_reduce_sum(buf: torch.Tensor, group: DataGroup, kind: str) -> None:
    """In-place SUM over the group (gloo has no AVG: callers divide)."""
    with _Timed(group, kind, buf.device):
        try:
            dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group.group)
        except RuntimeError as e:
            raise RuntimeError(f"{group.world.backend} all_reduce of a {buf.dtype} tensor on "
                               f"{buf.device} failed (rank {group.world.rank}): {e}") from e


def _flat(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1).float() for t in tensors])


def _unflat(buf: torch.Tensor, like: List[torch.Tensor]) -> List[torch.Tensor]:
    out, at = [], 0
    for t in like:
        out.append(buf[at:at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return out


def all_mean(tensors: Dict[str, torch.Tensor], group: DataGroup,
             kind: str = "aux") -> Dict[str, torch.Tensor]:
    """Each tensor of the dict averaged over the group's ranks, in one
    all-reduce (float32; no gradient)."""
    if not group.parallel:
        return dict(tensors)
    like = [t.detach() for t in tensors.values()]
    buf = _flat(like)
    _all_reduce_sum(buf, group, kind)
    buf /= group.size
    return dict(zip(tensors, _unflat(buf, like)))


class _AllMean(torch.autograd.Function):
    """y = mean over ranks of x; dx = mean over ranks of dy: every rank's
    copy of y is an output, so each rank's x gets the average of all the
    ranks' cotangents."""

    @staticmethod
    def forward(ctx, x, group, kind):
        ctx.group, ctx.kind = group, kind
        y = x.detach().float().clone()
        _all_reduce_sum(y, group, kind)
        return (y / group.size).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        g = dy.detach().float().clone()
        _all_reduce_sum(g, ctx.group, ctx.kind)
        return (g / ctx.group.size).to(dy.dtype), None, None


def all_mean_autograd(x: torch.Tensor, group: DataGroup, kind: str = "bn") -> torch.Tensor:
    """The mean of `x` over the group's ranks, differentiable: the
    backward averages the cotangent over the ranks too (the transpose of
    a replicated mean). ``kind`` names it in the group's timings."""
    if not group.parallel:
        return x
    return _AllMean.apply(x, group, kind)


def average_gradients(params: Iterable[torch.nn.Parameter], group: DataGroup) -> None:
    """Every parameter's .grad replaced by its mean over the group's ranks,
    in one all-reduce (a parameter without a gradient counts as zeros, as
    the optimizer sees it)."""
    if not group.parallel:
        return
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    buf = _flat(grads)
    _all_reduce_sum(buf, group, "grad")
    buf /= group.size
    for g, new in zip(grads, _unflat(buf, grads)):
        g.copy_(new)


def broadcast_module(module: torch.nn.Module, group: DataGroup) -> None:
    """Parameters and buffers from the group's rank 0 to every rank, so
    that all ranks start from the same state."""
    if not group.parallel:
        return
    with torch.no_grad():  # the group's rank 0 is the world's: groups are ranks 0..n-1
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, src=0, group=group.group)


# ------------------------------------------------------------- batches
def _map_tensors(fn, obj):
    if torch.is_tensor(obj):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(fn, v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_map_tensors(fn, v) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_map_tensors(fn, v) for v in obj)
    return obj


def shard_batch(batch: Any, group: DataGroup) -> Any:
    """This rank's rows of every tensor of a global batch (dicts, tuples
    and lists of tensors with the batch as their leading axis)."""
    if group.size == 1:
        return batch
    return _map_tensors(lambda t: t[group.rows(t.shape[0])], batch)


def gather_batch(batch: Any, group: DataGroup) -> Any:
    """The global batch from every rank's rows, for every tensor of
    `batch`: each rank writes its rows into zeros of the global shape and
    one all-reduce sums them (exact: each element has one nonzero term;
    16-bit floats travel as float32). A sum, not an all-gather, since gloo
    takes CUDA tensors only in its all-reduce and broadcast."""
    if not group.parallel:
        return batch

    def gather(t):
        n = t.shape[0]
        buf = torch.zeros((n * group.size, *t.shape[1:]), dtype=_wire(t.dtype), device=t.device)
        buf[group.rank * n:(group.rank + 1) * n] = t
        _all_reduce_sum(buf, group, "gather")
        return buf.to(t.dtype)

    return _map_tensors(gather, batch)


def _wire(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype
