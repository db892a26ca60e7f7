"""Kernels 4 and 8: bilinear grid sample and its backward (``csrc/grid_sample.cu``).

Kernel 4 replaces ``extdm_tpu/ops/pallas_warp.py`` ``grid_sample`` (its
one-hot-matmul Pallas kernel, ``_make_kernel``); kernel 8 replaces
``_grid_sample_bwd_impl`` (its ``_make_bwd_kernel``). On the H100 both are
bound by bytes, and both take a tile of output pixels per block: one thread
per pixel computes its coordinates, padding fold, four corners and weights
once, into shared memory, and the block then streams the tile's channels in
vectors of up to 16 bytes. Kernel 8's d_grid is a per-pixel channel sum in
a fixed order, so it repeats bit for bit; its d_image goes to global memory
by vector reductions per corner. On the clamp and fold lines kernel 8 takes
the TPU kernel's derivatives (0 at the border's bounds, -1 on a reflection
fold, a corner out of range reads 0), where the plain version takes
autograd's; ``grid_sample_dgrid_plain`` is d_grid with the TPU kernel's
rules in plain torch.
``grid_sample_plan`` (a plain, tested function) gives the tile, the vector
width, kernel 8's lanes per pixel and the shared bytes (the source's
``grid_sample_smem`` query). The JAX package's VMEM/tileability gates
(``pallas_warp.supported``, ``_bwd_supported``) have no counterpart: every
warp of the path and its backward take the kernels.

``grid_sample`` runs the kernel for CUDA tensors and the plain version
(``grid_sample_plain``) for CPU tensors. On CUDA, when an operand needs a
gradient, it runs inside a ``torch.autograd.Function`` whose backward is
``grid_sample_bwd`` (kernel 8; its plain version ``grid_sample_plain_vjp`` is
the autograd of ``grid_sample_plain``). ``grid_sample.launches`` and
``grid_sample_bwd.launches`` count kernel launches. Each wrapper call is one
ctypes call; an operand that is contiguous and of the kernel's dtype is
passed as it is, and kernel 8's entry zero-fills d_image itself.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from extdm_tpu_torch import _build
from extdm_tpu_torch.ops.fused_stw import _needs_grad, _sm_count, plain_vjp
from extdm_tpu_torch.ops.warp import PADDING_MODES, grid_sample_dgrid_plain, grid_sample_plain

__all__ = ["grid_sample", "grid_sample_plain", "grid_sample_bwd", "grid_sample_plain_vjp",
           "grid_sample_dgrid_plain", "grid_sample_plan"]

FWD_PIXEL_BYTES = 32  # a pixel's record in shared memory (csrc/grid_sample.cu FwdPixel)
BWD_PIXEL_BYTES = 64  # (BwdPixel)
GROUP_BYTES = 64      # a lane group reads at least 64 bytes a load, where C allows
PIXEL_LANE_BYTES = 16  # a pixel of at most this many bytes takes one lane
BLOCKS_PER_SM = 4     # tiles shrink (to 32 pixels) until the launch has this many blocks an SM
MIN_TILE = 32
MAX_TILE_VECTORS = 1 << 24  # a tile's (pixel, vector) pairs: the kernel's float division


class GridSamplePlan(NamedTuple):
    """How kernel 4 (``backward`` False) or 8 runs a sample of shapes."""
    tile_h: int       # a block's tile of output pixels: tile_h x tile_w, tile_w a power of two
    tile_w: int
    tiles: int        # tiles a sample (ragged at the right and bottom edges)
    blocks: int       # B x tiles
    vec: int          # elements a vector load or store
    lanes: int        # kernel 8: lanes a pixel (a power of two up to 32); 0 for kernel 4
    smem: int         # dynamic shared bytes a block (the source's grid_sample_smem)
    image_elems: int  # a sample's elements (32-bit indices within it; 64-bit bases)
    out_elems: int


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


@functools.lru_cache(maxsize=512)
def grid_sample_plan(B: int, H: int, W: int, C: int, Ho: int, Wo: int, elem_size: int,
                     align: int, sms: int, backward: bool = False) -> GridSamplePlan:
    """The launch plan of kernel 4 or 8 for an image (B, H, W, C) of
    `elem_size`-byte elements sampled at (B, Ho, Wo) points, its operands'
    addresses multiples of `align` bytes (a power of two, at most 16), on a
    card of `sms` SMs.

    The vector is the widest of at most 16 bytes that divides C and the
    alignment. Kernel 4's tile holds 64-256 pixels, more where a pixel has
    few vectors. Kernel 8's pixel is taken by a group of lanes: the power of
    two, from GROUP_BYTES of vectors up to 32 lanes, that idles the fewest
    lanes over C's vectors (C = 67 in float32: 16 lanes, 80 slots; 32 would
    take 96), or one lane where a pixel's channels are at most
    PIXEL_LANE_BYTES (C = 3); its tile holds 64 pixels, 256 where a group
    has at most 4 lanes. A tile halves, down to MIN_TILE pixels, while the
    launch has fewer than BLOCKS_PER_SM blocks an SM (the 16 x 16 levels)."""
    if H * W * C >= 2 ** 31 or Ho * Wo * C >= 2 ** 31:
        raise ValueError(f"grid_sample_plan: a sample of {H}x{W}x{C} (out {Ho}x{Wo}) passes "
                         "32-bit indices")
    if backward and max(H, W) >= 2 ** 15:
        raise ValueError(f"grid_sample_plan: kernel 8 packs corners in 16 bits; got {H}x{W}")
    vec = max(v for v in (8, 4, 2, 1)
              if v * elem_size <= 16 and C % v == 0 and align % (v * elem_size) == 0)
    nv = C // vec
    if backward:
        most = min(32, _pow2_at_least(nv))
        least = min(most, max(1, GROUP_BYTES // (vec * elem_size)))
        groups = [least << i for i in range((most // least).bit_length())]
        lanes = min(groups, key=lambda n: (n * -(-nv // n), -n))
        if C * elem_size <= PIXEL_LANE_BYTES:
            lanes = 1
        tp = 256 if lanes <= 4 else 64
    else:
        lanes = 0
        tp = 64 if nv >= 16 else (128 if nv >= 8 else 256)
    if tp * nv >= MAX_TILE_VECTORS:
        raise ValueError(f"grid_sample_plan: {nv} vectors a pixel is too many")

    def shape(tp):  # (tile_h, tile_w, tiles a sample)
        tile_w = 8 if tp <= 64 else 16
        return tp // tile_w, tile_w, -(-Ho // (tp // tile_w)) * -(-Wo // tile_w)

    while tp > MIN_TILE and B * shape(tp)[2] < BLOCKS_PER_SM * sms:
        tp //= 2
    tile_h, tile_w, tiles = shape(tp)
    smem = _build.query("grid_sample", "grid_sample_smem", int(backward), tp)
    return GridSamplePlan(tile_h, tile_w, tiles, B * tiles, vec, lanes, smem, H * W * C,
                          Ho * Wo * C)


def _align(*tensors) -> int:
    """The largest power of two up to 16 that divides every tensor's address."""
    a = 16
    for t in tensors:
        while t.data_ptr() % a:
            a //= 2
    return a


def _check(what, image, grid, padding_mode):
    if not (image.is_cuda and grid.device == image.device):
        raise ValueError(f"{what}: image on {image.device}, grid on {grid.device}")
    if padding_mode not in PADDING_MODES:
        raise ValueError(f"unknown padding_mode: {padding_mode}")
    if image.ndim != 4 or grid.ndim != 4 or grid.shape[0] != image.shape[0] or grid.shape[-1] != 2:
        raise ValueError(f"{what}: image {tuple(image.shape)} vs grid {tuple(grid.shape)}")


def _grid_sample_forward(image, grid, padding_mode):
    _check("grid_sample", image, grid, padding_mode)
    B, H, W, C = image.shape
    _, Ho, Wo, _ = grid.shape
    image = image.detach().contiguous()
    grid = grid.detach().float().contiguous()
    out = torch.empty((B, Ho, Wo, C), dtype=image.dtype, device=image.device)
    plan = grid_sample_plan(B, H, W, C, Ho, Wo, image.element_size(), _align(image, out),
                            _sm_count(image.device))
    _build.launch("grid_sample", "grid_sample", _build.dtype_code(image.dtype),
                  image.data_ptr(), grid.data_ptr(), out.data_ptr(), B, H, W, C, Ho, Wo,
                  PADDING_MODES.index(padding_mode), plan.tile_h, plan.tile_w, plan.vec,
                  plan.smem, _build.stream(image))
    grid_sample.launches += 1
    return out


class _GridSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, image, grid, padding_mode):
        ctx.padding_mode = padding_mode
        ctx.save_for_backward(image, grid)
        return _grid_sample_forward(image, grid, padding_mode)

    @staticmethod
    def backward(ctx, g):
        image, grid = ctx.saved_tensors
        d_image, d_grid = grid_sample_bwd(g, image, grid, ctx.padding_mode,
                                          image_grad=ctx.needs_input_grad[0],
                                          grid_grad=ctx.needs_input_grad[1])
        return d_image, d_grid, None


def grid_sample(image: torch.Tensor, grid: torch.Tensor,
                padding_mode: str = "zeros") -> torch.Tensor:
    """image (B, H, W, C), grid (B, Ho, Wo, 2) -> (B, Ho, Wo, C), align_corners=True."""
    if image.device.type == "cpu":
        return grid_sample_plain(image, grid, padding_mode)
    if _needs_grad(image, grid):
        return _GridSample.apply(image, grid, padding_mode)
    return _grid_sample_forward(image, grid, padding_mode)


grid_sample.launches = 0


def grid_sample_bwd(g: torch.Tensor, image: torch.Tensor, grid: torch.Tensor,
                    padding_mode: str = "zeros", image_grad: bool = True,
                    grid_grad: bool = True) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Kernel 8: (d_image, d_grid) of ``grid_sample`` at (image, grid) for the
    cotangent g (B, Ho, Wo, C), each in its operand's dtype; None where its
    flag is off (the kernel then does none of that output's work)."""
    if image.device.type == "cpu":
        d_image, d_grid = grid_sample_plain_vjp(g, image, grid, padding_mode)
        return (d_image if image_grad else None), (d_grid if grid_grad else None)
    _check("grid_sample_bwd", image, grid, padding_mode)
    B, H, W, C = image.shape
    _, Ho, Wo, _ = grid.shape
    if g.device != image.device or tuple(g.shape) != (B, Ho, Wo, C):
        raise ValueError(f"grid_sample_bwd: cotangent {tuple(g.shape)} on {g.device}")
    if not (image_grad or grid_grad):
        return None, None
    image = image.detach().contiguous()
    grid = grid.detach().float().contiguous()
    g = g.detach().to(image.dtype).contiguous()
    f32 = dict(dtype=torch.float32, device=image.device)
    # float32 sums (zero-filled by the entry), rounded once into a bf16 d_image
    d_sum = torch.empty((B, H, W, C), **f32) if image_grad else None
    d_image = (torch.empty_like(image) if image_grad and image.dtype != torch.float32
               else d_sum)
    d_grid = torch.empty((B, Ho, Wo, 2), **f32) if grid_grad else None
    plan = grid_sample_plan(B, H, W, C, Ho, Wo, image.element_size(), _align(image, g),
                            _sm_count(image.device), True)
    P = _build.ptr
    _build.launch("grid_sample", "grid_sample_bwd", _build.dtype_code(image.dtype),
                  image.data_ptr(), grid.data_ptr(), g.data_ptr(), P(d_sum),
                  None if d_image is d_sum else P(d_image), P(d_grid), B, H, W, C, Ho, Wo,
                  PADDING_MODES.index(padding_mode), plan.tile_h, plan.tile_w, plan.vec,
                  plan.lanes, plan.smem, _build.stream(image))
    grid_sample_bwd.launches += 1
    return d_image, (None if d_grid is None else d_grid.to(grid.dtype))


grid_sample_bwd.launches = 0


def grid_sample_plain_vjp(g: torch.Tensor, image: torch.Tensor, grid: torch.Tensor,
                          padding_mode: str = "zeros"):
    """The plain version of kernel 8: autograd of ``grid_sample_plain``,
    (d_image, d_grid)."""
    return plain_vjp(grid_sample_plain, g, image, grid, padding_mode=padding_mode)
