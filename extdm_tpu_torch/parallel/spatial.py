"""The spatial (sequence-parallel) mesh: the batch over ``data`` ranks and
the latent H axis over ``model`` ranks (the port of the (data, model) mesh of
extdm_tpu/parallel/mesh.py ``make_mesh`` as
``FlowDiffusion.make_spatial_sampler`` uses it), with the cross-shard
exchanges that GSPMD inserts in the JAX package written out by hand.

- ``make_spatial_mesh(world, data, model)``: rank r = d * model + m, JAX's
  device order (``make_mesh`` reshapes the devices to (data, model)). One
  process group per model row (the ranks that split one batch slice's H)
  and per data column (the ranks that split the batch at one H slice);
  every rank makes every group, in the same order.
- Shard m of a global H holds rows [m H / M, (m + 1) H / M); ``slice_h``
  cuts them, ``gather_h`` puts the global H back together.
- ``halo(x, top, bottom, edge)``: x's rows with `top` rows of the previous
  shard above and `bottom` rows of the next one below. ``edge="zero"`` gives
  the first and last shards zeros (a convolution's padding),
  ``edge="cyclic"`` wraps around (the shifted-window roll), ``edge="clamp"``
  repeats the global first and last rows (a bilinear resize's edge).
- ``moments(x, dims)``: the global mean and sum of squared deviations of x
  over `dims` (which hold the H axis), for GroupNorm and the extrapolator's
  statistics.

Every exchange is one float32 (or the tensor's own wider type) all-reduce
of a zero-filled buffer over the model group: each rank writes its part
into its own slot and reads the slots it needs. That is exact (each element
has one nonzero term), and gloo takes CUDA tensors in its all-reduce (not in
its all-gather or point-to-point calls), so the same code runs over nccl,
over gloo on the card and over gloo on the CPU. ``timings``, where a caller
sets it to a dict, collects each exchange's milliseconds by kind ("halo",
"stats", "gather_h", "threshold", "traj" for the trajwarp family's resize
of its warped features, and "gather" for the batch rows), each
bracketed by a device sync, as ``DataGroup.timings`` does. Inference only:
no exchange has a backward.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from extdm_tpu_torch.parallel.mesh import DataGroup, World, _Timed, _wire, gather_batch

EDGES = ("zero", "cyclic", "clamp")


@dataclass(eq=False)
class SpatialMesh:
    """This rank's place in a (data, model) mesh: its data row ``d`` and H
    shard ``m``, the process group of its model row (None where model is
    1), and ``columns``, the data group of its model column (the batch
    split: ``rows``, and the gather of a result's rows). A hybrid (dcn,
    data, model) mesh (``parallel.tensor.make_hybrid_mesh``) is this mesh
    with its dcn x data rows flattened, ``dcn`` recorded. For the
    tensor-parallel step, ``m`` is the rank's slice of each ruled weight."""
    data: int
    model: int
    world: World
    d: int
    m: int
    model_group: Any = None
    columns: Optional[DataGroup] = None
    timings: Optional[Dict[str, List[float]]] = field(default=None, repr=False)
    dcn: int = 1

    # ------------------------------------------------------------ layout
    def rows(self, batch: int) -> slice:
        """This rank's rows of a global batch of `batch`."""
        if batch % self.data:
            raise ValueError(f"batch {batch} does not split over {self.data} data ranks")
        per = batch // self.data
        return slice(self.d * per, (self.d + 1) * per)

    def h_rows(self, H: int) -> slice:
        """This shard's rows of a global H."""
        if H % self.model:
            raise ValueError(f"H = {H} does not split over {self.model} model ranks")
        per = H // self.model
        return slice(self.m * per, (self.m + 1) * per)

    def aligned(self, H: int, window_h: int) -> bool:
        """Whether the windows of height `window_h` over a global H lie
        within the shards: H splits evenly and each shard holds whole
        windows (no H padding)."""
        return H % self.model == 0 and (H // self.model) % window_h == 0

    def slice_h(self, x: torch.Tensor) -> torch.Tensor:
        """This shard's rows of a global (B, T, H, ...) tensor."""
        return x[:, :, self.h_rows(x.shape[2])]

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's batch rows and H rows of a global (B, T, H, ...) tensor."""
        return self.slice_h(x[self.rows(x.shape[0])])

    # --------------------------------------------------------- exchanges
    def sum_over_model(self, t: torch.Tensor, kind: str = "stats") -> torch.Tensor:
        """`t` summed over the model ranks, in place (a float32 or wider tensor)."""
        if self.model > 1:
            with _Timed(self, kind, t.device):
                dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.model_group)
        return t

    def gather_h(self, x: torch.Tensor, kind: str = "gather_h") -> torch.Tensor:
        """The global (B, T, H, ...) tensor from every shard's rows."""
        if self.model == 1:
            return x
        HL = x.shape[2]
        buf = torch.zeros((*x.shape[:2], HL * self.model, *x.shape[3:]), dtype=_wire(x.dtype),
                          device=x.device)
        buf[:, :, self.m * HL:(self.m + 1) * HL] = x
        return self.sum_over_model(buf, kind).to(x.dtype)

    def halo(self, x: torch.Tensor, top: int, bottom: int, edge: str,
             kind: str = "halo") -> torch.Tensor:
        """(B, T, HL, ...) -> (B, T, top + HL + bottom, ...): x with the last
        `top` rows of the previous shard above it and the first `bottom` rows
        of the next shard below it; past the global edges zeros
        (``edge="zero"``), the rows of the other end (``"cyclic"``) or the
        global first and last rows repeated (``"clamp"``). Where a neighbour
        holds fewer rows than asked for, the rows come from the gathered
        global H."""
        if edge not in EDGES:
            raise ValueError(f"edge is one of {EDGES}, got {edge!r}")
        if top == 0 and bottom == 0:
            return x
        HL = x.shape[2]
        if max(top, bottom) > HL:
            full = self.gather_h(x, kind)
            return _global_rows(full, self.m * HL - top, (self.m + 1) * HL + bottom, edge)
        M, m = self.model, self.m
        # slot r: rank r's last `top` rows (the next rank's top halo), then
        # its first `bottom` rows (the previous rank's bottom halo)
        buf = torch.zeros((M, *x.shape[:2], top + bottom, *x.shape[3:]), dtype=_wire(x.dtype),
                          device=x.device)
        buf[m, :, :, :top] = x[:, :, HL - top:]
        buf[m, :, :, top:] = x[:, :, :bottom]
        self.sum_over_model(buf, kind)
        parts = []
        if top:
            above = buf[(m - 1) % M, :, :, :top]
            parts.append(_edge_rows(x[:, :, :1], above, edge) if m == 0 else above)
        parts.append(x.to(buf.dtype))
        if bottom:
            below = buf[(m + 1) % M, :, :, top:]
            parts.append(_edge_rows(x[:, :, -1:], below, edge) if m == M - 1 else below)
        return torch.cat(parts, dim=2).to(x.dtype)

    def margin_rows(self, full: torch.Tensor, top: int, bottom: int, edge: str) -> torch.Tensor:
        """This shard's rows of a global (B, T, H, ...) tensor that every
        rank holds whole, with `top` rows above and `bottom` below, past the
        global edges as ``halo``'s `edge`: ``halo`` without an exchange."""
        HL = full.shape[2] // self.model
        return _global_rows(full, self.m * HL - top, (self.m + 1) * HL + bottom, edge)

    def moments(self, x: torch.Tensor, dims: Sequence[int]):
        """(mean, m2, n) of float32 x over `dims`, which hold the H axis (dim
        2), over every shard: the global mean, the global sum of squared
        deviations from it and the global count, keepdim. Each rank's own
        (mean, m2) travel in one all-reduce of rank slots and are combined
        as Chan et al. combine partial moments (m2 = sum of the m2s + n_r
        times the squared offsets of the means), not as E[x^2] - E[x]^2."""
        n = 1
        for d in dims:
            n *= x.shape[d]
        mean = x.mean(dim=tuple(dims), keepdim=True)
        m2 = ((x - mean) ** 2).sum(dim=tuple(dims), keepdim=True)
        if self.model == 1:
            return mean, m2, n
        buf = torch.zeros((self.model, 2, *mean.shape), dtype=torch.float32, device=x.device)
        buf[self.m, 0], buf[self.m, 1] = mean, m2
        self.sum_over_model(buf, "stats")
        means = buf[:, 0]
        total = means.mean(dim=0)  # equal counts on every shard
        return total, buf[:, 1].sum(dim=0) + n * ((means - total) ** 2).sum(dim=0), n * self.model

    def gather_rows(self, batch: Any) -> Any:
        """The global batch from every data row's rows (``gather_batch`` over
        this rank's model column), timed as kind "gather"."""
        self.columns.timings = self.timings
        try:
            return gather_batch(batch, self.columns)
        finally:
            self.columns.timings = None


def _edge_rows(edge_row: torch.Tensor, rows: torch.Tensor, edge: str) -> torch.Tensor:
    """The rows past a global edge in place of `rows` (what the cyclic
    neighbour sent): zeros, `rows` itself (cyclic) or the edge row
    repeated (clamp)."""
    if edge == "zero":
        return torch.zeros_like(rows)
    if edge == "clamp":
        return edge_row.to(rows.dtype).expand_as(rows)
    return rows


def _global_rows(full: torch.Tensor, lo: int, hi: int, edge: str) -> torch.Tensor:
    """Rows [lo, hi) of a global (B, T, H, ...) tensor, past its edges zeros,
    wrapped around or the edge rows repeated."""
    H = full.shape[2]
    idx = torch.arange(lo, hi, device=full.device)
    rows = full.index_select(2, idx.clamp(0, H - 1) if edge == "clamp" else idx % H)
    if edge == "zero":
        inside = ((idx >= 0) & (idx < H)).to(rows.dtype)
        rows = rows * inside.reshape(1, 1, -1, *([1] * (full.ndim - 3)))
    return rows


def make_spatial_mesh(world: World, data: int, model: int) -> SpatialMesh:
    """The (data, model) mesh of a world of data x model ranks (every rank
    calls it: its groups are made collectively)."""
    if data < 1 or model < 1 or world.size != data * model:
        raise ValueError(f"a (data {data}, model {model}) mesh needs {data * model} ranks; "
                         f"the world has {world.size}")
    d, m = divmod(world.rank, model)
    model_group = column_group = None
    if model > 1:
        for row in range(data):
            g = dist.new_group([row * model + i for i in range(model)])
            if row == d:
                model_group = g
    if data > 1:
        for col in range(model):
            g = dist.new_group([i * model + col for i in range(data)])
            if col == m:
                column_group = g
    columns = DataGroup(size=data, rank=d, world=world, group=column_group)
    return SpatialMesh(data=data, model=model, world=world, d=d, m=m, model_group=model_group,
                       columns=columns)
