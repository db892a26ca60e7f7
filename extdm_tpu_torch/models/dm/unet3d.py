"""3-D diffusion UNet over the flow + occlusion latents (port of
extdm_tpu/models/dm/unet3d.py): the ``adaptor`` conditioning family, whose
(x, t)-invariant conditioning stream is computed once a sampler call
(``cond_only`` / ``cond_cache``), and the ``trajwarp`` family of the
``w_ref/traj`` preset, whose init conv lifts the latents to the features'
width and warps the cond features toward them (``TrajWarp``) at every call.
Optional classifier-free guidance plumbing: ``cond_dim`` widens the time
embedding by a given condition embedding, ``null_cond_mask`` swaps in the
(learned, with ``learn_null_cond``) null embedding per sample.

Per level: two time-conditioned ResnetBlock3d, a shifted and a plain window
attention layer, a MotionAdaptor and a temporal attention layer. On the card
the resnet blocks and both attention layers run as this package's CUDA
kernels (``ops/fused_*.py``); on the CPU as their plain versions. An
attention layer the whole-layer kernels do not take (``stw_route``: a
temporal layer of more than 256 channels, as at the deepest level of the
multi1248 preset; a bf16 window layer takes 512 forward and backward)
runs unfused, its attention core on kernel 12; a resnet block's backward takes
``resnet_bwd_route``'s route (kernel 7; in float32 kernels 10 and 11 for Cout
> 256).
Parameter names follow the reference denoiser's state dict
(``downs.{i}.{0..6}``, ``mid_block1``, ``final_conv.0``, ...), so
``convert.py`` maps the JAX variables onto them. Layout (B, T, H, W, C).

Dtype policy, as in the flax modules: ``dtype`` is the compute type (None:
float32); parameters keep their own type (float32 master weights when
training) and each layer casts them to the compute type where it uses them.
The time MLP runs in float32 and norm statistics stay float32. With
``remat``, the MotionAdaptors run under ``torch.utils.checkpoint``: their
autograd would keep every intermediate of the extrapolator, while the
kernel layers' autograd Functions already keep only their inputs.

On an H shard (``forward(..., shard=mesh)``, a ``parallel.SpatialMesh``;
inference, the port of the DDIM stage of JAX's ``make_spatial_sampler``):
x and the cond frames are the shard's rows of the global latent H, and
every module that reads across rows exchanges them by hand. The (1, k, k)
convolutions (init conv, resnet convs, Down/Upsample) read halo rows of
their neighbours (``conv_frames``); the resnet blocks run as
``resnet_block_sharded``, their GroupNorm statistics combined over the
shards: the counterpart of the XLA path that JAX's spatial sampler runs its
blocks on (``pallas_resnet.inference_only_scope``), so kernel 3 does not
run there. The STW layers run as ``spatial_stw_layer`` (kernel 1 on the
shard's windows), the temporal layers as ``spatial_temporal_layer`` (kernel
2 unchanged), the MotionAdaptors with combined statistics. Windows, shifts
and the position bias are those of the global shape; the conditioning
stream is computed on the global H once a call and cut to the shard's rows.
In the ``trajwarp`` family the init noise conv reads halos as the init
conv does; ``TrajWarp`` runs on the shard's rows with the cond features
whole (no exchange); the 2x bilinear resize of its result to the latent H
reads one row above and one below each shard's rows, clamped at the global
edges: the cond frames' rows are cut from the whole features, the warped
frames' rows come from the neighbours (one ``"clamp"`` halo of kind
``"traj"`` a call; ``upsample_rows_2x``).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from extdm_tpu_torch.models.dm.adaptor import MotionAdaptor, PointwiseConv3d, PreNorm, TrajWarp
from extdm_tpu_torch.nn.attention import (RelativePositionBias, RelativePositionBiasTHW,
                                          TemporalAttentionLayer, WindowAttention3D,
                                          get_window_size)
from extdm_tpu_torch.nn.layers import cast
from extdm_tpu_torch.ops.fused_resnet import fused_resnet_block
from extdm_tpu_torch.ops.fused_stw import (WINDOW_MAJOR_MODES, fused_stw_layer,
                                           fused_temporal_layer, spatial_stw_layer,
                                           spatial_temporal_layer, stw_layer_unfused, stw_route,
                                           temporal_layer_unfused)
from extdm_tpu_torch.ops.resize import interpolate_bilinear
from extdm_tpu_torch.utils.profiler import span


def sinusoidal_pos_emb(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(torch.arange(half, device=t.device) * -(math.log(10000) / (half - 1)))
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([args.sin(), args.cos()], dim=-1)


class SinusoidalPosEmb(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t):
        return sinusoidal_pos_emb(t, self.dim)


def conv_frames(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], dtype,
                stride: int = 1, padding: int = 0, transpose: bool = False,
                shard=None) -> torch.Tensor:
    """A (1, k, k) Conv3d (or ConvTranspose3d) applied frame by frame to
    (B, T, H, W, C), computing in `dtype`. With `shard`, x is an H shard's
    rows and so is the result (``_conv_rows``)."""
    if shard is not None:
        return _conv_rows(x, weight, bias, dtype, stride, padding, transpose, shard)
    return _frames(x, weight, bias, dtype, stride, padding, transpose)


def _frames(x, weight, bias, dtype, stride, padding, transpose):
    B, T, H, W, C = x.shape
    xf = x.to(dtype).reshape(B * T, H, W, C).permute(0, 3, 1, 2)
    op = F.conv_transpose2d if transpose else F.conv2d
    y = op(xf, weight.squeeze(2).to(dtype), cast(bias, dtype), stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1).reshape(B, T, *y.shape[2:], y.shape[1])


def _conv_rows(x, weight, bias, dtype, stride, padding, transpose, shard):
    """``conv_frames`` on an H shard's rows (HL of them): the rows its output
    rows read, from the neighbours as zero-edge halos, then the conv with
    no H padding. A conv with stride s reads rows [s i - p, s i - p + k) for
    output row i: p rows above the shard and k - s - p below (HL a multiple
    of s: the output's rows split over the shards). A transposed conv's
    output rows [s HL m, s HL (m + 1)) read ceil((k - 1 - p) / s) input rows
    on each side; its full output is cropped to them."""
    k, HL = weight.shape[-1], x.shape[2]
    x = x.to(dtype)
    if transpose:
        a = -(-(k - 1 - padding) // stride)
        y = _frames(shard.halo(x, a, a, "zero"), weight, bias, dtype, stride, (0, padding), True)
        crop = stride * a + padding
        return y[:, :, crop:crop + stride * HL]
    if HL % stride:
        raise ValueError(f"a stride-{stride} conv's output rows do not split over the shards "
                         f"of {HL} rows")
    xh = shard.halo(x, padding, k - stride - padding, "zero")
    return _frames(xh, weight, bias, dtype, stride, (0, padding), False)


def _group_norm_rows(y: torch.Tensor, scale, bias, groups: int, eps: float,
                     shard) -> torch.Tensor:
    """``fused_resnet._group_norm`` on an H shard: float32 statistics over
    (T, H, W, C/G) per sample, combined over the shards; returns float32."""
    B, T, H, W, C = y.shape
    g = y.float().reshape(B, T, H, W, groups, C // groups)
    mean, m2, n = shard.moments(g, (1, 2, 3, 5))
    g = (g - mean) * torch.rsqrt(m2 / n + eps)
    return g.reshape(y.shape) * scale.float() + bias.float()


def resnet_block_sharded(x, w1, b1, g1s, g1b, film: Optional[torch.Tensor], w2, b2, g2s, g2b,
                         wres=None, bres=None, *, shard, groups=8, eps=1e-5):
    """``resnet_block_plain`` on an H shard's rows: each 3x3 conv reads one
    zero-edge halo row of each neighbour, each GroupNorm combines its
    statistics over the shards; FiLM, SiLU and the residual act on each
    pixel. Convs in x.dtype, statistics in float32, as the plain block. It
    is the counterpart of JAX's spatial sampler's XLA blocks, which GSPMD
    partitions: kernel 3 does not run here."""
    dtype = x.dtype
    h = _group_norm_rows(conv_frames(x, w1, b1, dtype, padding=1, shard=shard), g1s, g1b,
                         groups, eps, shard)
    if film is not None:
        scale, shift = film.float().chunk(2, dim=-1)
        h = h * (scale[:, None, None, None] + 1.0) + shift[:, None, None, None]
    h = F.silu(h).to(dtype)
    h2 = F.silu(_group_norm_rows(conv_frames(h, w2, b2, dtype, padding=1, shard=shard), g2s,
                                 g2b, groups, eps, shard)).to(dtype)
    res = x
    if wres is not None:
        res = x @ wres.to(dtype).flatten(1).t() + bres.to(dtype)
    return (h2 + res).to(dtype)


def upsample_rows_2x(xh: torch.Tensor) -> torch.Tensor:
    """The H half of a 2x bilinear upsample (align_corners=False) of R rows
    given with one row above and one below: (..., R + 2, W, C) -> (..., 2R,
    W, C). Output row 2j reads rows j - 1 and j (1/4, 3/4), row 2j + 1 rows
    j and j + 1 (3/4, 1/4); in float32, returned in xh's dtype."""
    x = xh.float()
    above, mid, below = x[..., :-2, :, :], x[..., 1:-1, :, :], x[..., 2:, :, :]
    out = torch.stack([0.25 * above + 0.75 * mid, 0.75 * mid + 0.25 * below], dim=-3)
    return out.reshape(*x.shape[:-3], 2 * mid.shape[-3], *x.shape[-2:]).to(xh.dtype)


def _traj_features_rows(f: torch.Tensor, cond_fea: torch.Tensor, tc: int, shard,
                        size) -> torch.Tensor:
    """``TrajWarp``'s result on an H shard (its rows of every frame at the
    features' H) resized 2x to the shard's rows of the latent (H, W), as the
    unsharded bilinear resize of the whole result: the cond frames' rows
    with their margin cut from the whole features, the warped frames' from
    the neighbours (a clamped halo, kind "traj")."""
    H, W = size
    if 2 * cond_fea.shape[2] != H:
        raise ValueError(f"features of {cond_fea.shape[2]} rows resize 2x to the latent H = {H} "
                         "on an H shard, not otherwise")
    rows = torch.cat([shard.margin_rows(cond_fea[:, :tc], 1, 1, "clamp").to(f.dtype),
                      shard.halo(f[:, tc:], 1, 1, "clamp", kind="traj")], dim=1)
    rows = upsample_rows_2x(rows)
    B, T = rows.shape[:2]
    return interpolate_bilinear(rows.reshape(B * T, *rows.shape[2:]),
                                (rows.shape[2], W)).reshape(B, T, rows.shape[2], W, -1)


def _call(module: nn.Module, x: torch.Tensor, shard) -> torch.Tensor:
    """A level's optional module (an adaptor or a resample; nn.Identity
    where the level has none) on x."""
    return x if isinstance(module, nn.Identity) else module(x, shard=shard)


class Block3d(nn.Module):
    """conv (1,3,3) + GroupNorm parameters of one half of a ResnetBlock3d."""

    def __init__(self, dim: int, dim_out: int, groups: int = 8):
        super().__init__()
        self.proj = nn.Conv3d(dim, dim_out, (1, 3, 3), padding=(0, 1, 1))
        self.norm = nn.GroupNorm(groups, dim_out, eps=1e-5)


class ResnetBlock3d(nn.Module):
    """Two Block3d with FiLM time conditioning and a residual; runs as
    ``fused_resnet_block``."""

    def __init__(self, dim: int, dim_out: int, time_emb_dim: Optional[int] = None,
                 groups: int = 8, dtype=None):
        super().__init__()
        self.groups = groups
        self.compute_dtype = dtype or torch.float32
        self.mlp = (nn.Sequential(nn.SiLU(), nn.Linear(time_emb_dim, dim_out * 2))
                    if time_emb_dim is not None else None)
        self.block1 = Block3d(dim, dim_out, groups)
        self.block2 = Block3d(dim_out, dim_out, groups)
        self.res_conv = nn.Conv3d(dim, dim_out, 1) if dim != dim_out else None

    def forward(self, x, time_emb=None, shard=None):
        film = None
        dt = self.compute_dtype
        if self.mlp is not None and time_emb is not None:
            lin = self.mlp[1]
            film = F.linear(self.mlp[0](time_emb.to(dt)), lin.weight.to(dt), lin.bias.to(dt))
        b1, b2, rc = self.block1, self.block2, self.res_conv
        args = (x.to(dt), b1.proj.weight, b1.proj.bias, b1.norm.weight, b1.norm.bias, film,
                b2.proj.weight, b2.proj.bias, b2.norm.weight, b2.norm.bias,
                rc.weight if rc is not None else None, rc.bias if rc is not None else None)
        if shard is not None:
            return resnet_block_sharded(*args, shard=shard, groups=self.groups)
        return fused_resnet_block(*args, groups=self.groups)


class Downsample(nn.Conv3d):
    """conv (1,4,4) stride (1,2,2)."""

    def __init__(self, dim: int, dtype=None):
        super().__init__(dim, dim, (1, 4, 4), (1, 2, 2), (0, 1, 1))
        self.compute_dtype = dtype or torch.float32

    def forward(self, x, shard=None):
        return conv_frames(x, self.weight, self.bias, self.compute_dtype, stride=2, padding=1,
                           shard=shard)


class Upsample(nn.ConvTranspose3d):
    """transposed conv (1,4,4) stride (1,2,2): doubles H and W."""

    def __init__(self, dim: int, dtype=None):
        super().__init__(dim, dim, (1, 4, 4), (1, 2, 2), (0, 1, 1))
        self.compute_dtype = dtype or torch.float32

    def forward(self, x, shard=None):
        return conv_frames(x, self.weight, self.bias, self.compute_dtype, stride=2, padding=1,
                           transpose=True, shard=shard)


class STWAttentionLayer(nn.Module):
    """Holds the window attention parameters (reference STWAttentionLayer)."""

    def __init__(self, dim: int, window_size, heads: int, dim_head: int):
        super().__init__()
        self.attn = WindowAttention3D(dim, window_size, heads, dim_head)


class PreNormSTW(nn.Module):
    """Residual(PreNorm(STWAttentionLayer)); runs as ``fused_stw_layer``, or
    as ``stw_layer_unfused`` where ``stw_route`` says so."""

    def __init__(self, dim: int, window_size: Tuple[int, int, int],
                 shift_size: Tuple[int, int, int], heads: int, dim_head: int,
                 window_major: str = "0"):
        super().__init__()
        self.window_size, self.shift_size = tuple(window_size), tuple(shift_size)
        self.heads, self.dim_head, self.window_major = heads, dim_head, window_major
        self.fn = PreNorm(dim, STWAttentionLayer(dim, window_size, heads, dim_head))

    def forward(self, x, shard=None):
        T, H, W = x.shape[1:4]
        if shard is not None:  # the window and shift of the global shape
            H *= shard.model
        window, shift = get_window_size((T, H, W), self.window_size, self.shift_size)
        attn = self.fn.fn.attn
        N = window[0] * window[1] * window[2]
        args = (x, self.fn.norm.gamma.reshape(-1), attn.qkv.weight, attn.proj.weight,
                attn.proj.bias, attn.bias_hnn(N))
        kw = dict(window=window, shift=shift, heads=self.heads, dim_head=self.dim_head)
        route = stw_route(x.shape[-1], N, self.dim_head, x.dtype, heads=self.heads)
        if shard is not None:
            return spatial_stw_layer(*args, shard=shard, window_major=self.window_major,
                                     route=route, **kw)
        if route == "unfused":
            return stw_layer_unfused(*args, **kw)
        return fused_stw_layer(*args, window_major=self.window_major, **kw)


class _Rearranged(nn.Module):
    """Holds `fn` where the reference wraps it in EinopsToAndFrom."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn


class PreNormTemporalAttn(nn.Module):
    """Residual(PreNorm(EinopsToAndFrom(AttentionLayer))) over T; runs as
    ``fused_temporal_layer``, or as ``temporal_layer_unfused`` where
    ``stw_route`` says so."""

    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.fn = PreNorm(dim, _Rearranged(TemporalAttentionLayer(dim, heads, dim_head)))

    def forward(self, x, pos_bias=None, shard=None):
        T = x.shape[1]
        layer = self.fn.fn.fn
        if pos_bias is None:
            bias = torch.zeros(self.heads, T, T, device=x.device)
        elif pos_bias.ndim == 4:  # THW bias: reduced per query, broadcast over keys
            bias = pos_bias.mean(dim=(-2, -1))[:, :, None].expand(self.heads, T, T)
        else:
            bias = pos_bias
        route = stw_route(x.shape[-1], T, self.dim_head, x.dtype, heads=self.heads, temporal=True)
        args = (x, self.fn.norm.gamma.reshape(-1), layer.norm.weight, layer.norm.bias,
                layer.attn.to_qkv.weight, layer.attn.to_out.weight, bias)
        kw = dict(heads=self.heads, dim_head=self.dim_head)
        if shard is not None:
            return spatial_temporal_layer(*args, route=route, **kw)
        layer_fn = temporal_layer_unfused if route == "unfused" else fused_temporal_layer
        return layer_fn(*args, **kw)


class Unet3D(nn.Module):
    def __init__(self, dim: int = 64, out_grid_dim: int = 2, out_conf_dim: int = 1,
                 window_size: Tuple[int, int, int] = (4, 4, 4),
                 dim_mults: Sequence[int] = (1, 2, 4, 4), channels: int = 3,
                 cond_feature_dim: int = 256, attn_heads: int = 8, attn_dim_head: int = 32,
                 init_dim: Optional[int] = None, init_kernel_size: int = 7,
                 resnet_groups: int = 8, use_final_activation: bool = False, cond_num: int = 0,
                 pred_num: int = 0, use_ref_features: bool = True,
                 conditioning: str = "adaptor", down_adaptor_from_level: int = 0,
                 cond_dim: Optional[int] = None, learn_null_cond: bool = False,
                 path: int = 0, remat: bool = True, dtype=None, stw_window_major: str = "0"):
        super().__init__()
        if conditioning not in ("adaptor", "trajwarp", "none"):
            raise ValueError(f"conditioning is adaptor, trajwarp or none, got {conditioning!r}")
        if stw_window_major not in WINDOW_MAJOR_MODES:
            raise ValueError(f"stw_window_major is one of {WINDOW_MAJOR_MODES}, "
                             f"got {stw_window_major!r}")
        wm = stw_window_major
        self.channels, self.path, self.remat = channels, path, remat
        self.compute_dtype = dt = dtype or torch.float32
        self.cond_num, self.pred_num = cond_num, pred_num
        self.use_ref_features = use_ref_features
        self.traj = use_ref_features and conditioning == "trajwarp"
        self.use_final_activation = use_final_activation
        self.cond_dim = cond_dim
        heads, dh = attn_heads, attn_dim_head
        shift = tuple(w // 2 for w in window_size)
        init_dim, k0 = init_dim or dim, init_kernel_size
        self.init_pad = k0 // 2

        if path == 1:
            self.rel_pos_bias_thw = RelativePositionBiasTHW(heads=heads, max_distance=32)
            self.alpha = nn.Parameter(torch.ones(heads))
            self.beta = nn.Parameter(torch.ones(heads))
        else:
            self.time_rel_pos_bias = RelativePositionBias(heads=heads, max_distance=32)

        if self.traj:
            # the latents lifted to the features' width, then [lifted, warped features]
            self.init_noise_conv = nn.Conv3d(channels, cond_feature_dim, (1, k0, k0),
                                             padding=(0, k0 // 2, k0 // 2))
            self.init_traj = TrajWarp(cond_feature_dim, cond_num, pred_num, heads, dt)
            in_ch = 2 * cond_feature_dim
        else:
            in_ch = channels + (cond_feature_dim if use_ref_features else 0)
        self.init_conv = nn.Conv3d(in_ch, init_dim, (1, k0, k0), padding=(0, k0 // 2, k0 // 2))
        if use_ref_features and not self.traj:
            self.cond_adaptor = MotionAdaptor(cond_feature_dim, cond_num, pred_num, dt)
            self.cond_temporal_attn = PreNormTemporalAttn(cond_feature_dim, heads, dh)
        self.init_temporal_attn = PreNormTemporalAttn(init_dim, heads, dh)

        time_dim = dim * 4
        self.time_mlp = nn.Sequential(SinusoidalPosEmb(dim), nn.Linear(dim, time_dim),
                                      nn.GELU(approximate="tanh"), nn.Linear(time_dim, time_dim))
        if cond_dim is not None:
            self.null_cond_emb = (nn.Parameter(torch.randn(1, cond_dim)) if learn_null_cond
                                  else None)
            time_dim += cond_dim

        dims = [init_dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        n = len(in_out)

        def level(d_in, d_out, adaptor, resample):
            return nn.ModuleList([
                ResnetBlock3d(d_in, d_out, time_dim, resnet_groups, dt),
                PreNormSTW(d_out, window_size, shift, heads, dh, wm),
                ResnetBlock3d(d_out, d_out, time_dim, resnet_groups, dt),
                PreNormSTW(d_out, window_size, (0, 0, 0), heads, dh, wm),
                MotionAdaptor(d_out, cond_num, pred_num, dt) if adaptor else nn.Identity(),
                PreNormTemporalAttn(d_out, heads, dh),
                resample(d_out, dt) if resample is not None else nn.Identity(),
            ])

        # per-level MotionAdaptors in both the adaptor and the trajwarp family
        ada = conditioning in ("adaptor", "trajwarp")
        self.downs = nn.ModuleList(
            level(d_in, d_out, ada and i >= down_adaptor_from_level,
                  Downsample if i < n - 1 else None)
            for i, (d_in, d_out) in enumerate(in_out))
        mid = dims[-1]
        self.mid_block1 = ResnetBlock3d(mid, mid, time_dim, resnet_groups, dt)
        self.mid_attn1 = PreNormSTW(mid, window_size, shift, heads, dh, wm)
        self.mid_block2 = ResnetBlock3d(mid, mid, time_dim, resnet_groups, dt)
        self.mid_attn2 = PreNormSTW(mid, window_size, (0, 0, 0), heads, dh, wm)
        self.mid_adaptor = MotionAdaptor(mid, cond_num, pred_num, dt) if ada else nn.Identity()
        self.ups = nn.ModuleList(
            level(d_out * 2, d_in, ada and i > 1, Upsample if i < n - 1 else None)
            for i, (d_in, d_out) in enumerate(reversed(in_out)))
        # the last up level gives init_dim channels, concatenated with the init conv's
        self.final_conv = nn.Sequential(ResnetBlock3d(init_dim * 2, dim, None, resnet_groups, dt),
                                        PointwiseConv3d(dim, out_grid_dim, dtype=dt))
        self.occlusion_map = nn.Sequential(
            ResnetBlock3d(init_dim * 2, dim, None, resnet_groups, dt),
            PointwiseConv3d(dim, out_conf_dim, dtype=dt))

    def _global_h(self, HL: int, shard) -> int:
        """The global latent H of a shard's HL rows; every level's H must
        split over the model ranks (so, with two levels or more, a shard's
        rows are even, as the trajwarp family's 2x2 max-pool needs)."""
        H = HL * shard.model
        deepest = shard.model * 2 ** (len(self.downs) - 1)
        if H % deepest:
            raise ValueError(f"latent H = {H} does not split over {shard.model} model ranks at "
                             f"every one of the {len(self.downs)} levels")
        return H

    def _pos_bias(self, T: int, H: int, W: int) -> torch.Tensor:
        if self.path != 1:
            return self.time_rel_pos_bias(T)
        t_bias, h_bias, w_bias = self.rel_pos_bias_thw(T, H, W)
        heads = t_bias.shape[0]

        def resize(b):
            return interpolate_bilinear(b[..., None], (T, T))[..., 0]

        hb = resize(h_bias)[:, None, :, :]
        wb = resize(w_bias)[:, :, None, :]
        tb = t_bias[:, :, None, :]
        full = (heads, T, T, T)
        return (self.alpha[:, None, None, None] * tb.expand(full)
                + self.beta[:, None, None, None] * (hb.expand(full) + wb.expand(full)))

    def _adapt(self, adaptor: nn.Module, x: torch.Tensor, shard=None) -> torch.Tensor:
        if self.remat and isinstance(adaptor, MotionAdaptor) and torch.is_grad_enabled():
            return checkpoint(adaptor, x, shard, use_reentrant=False)
        return _call(adaptor, x, shard)

    def cond_stream(self, cond_fea: torch.Tensor, H: int, W: int,
                    pos_bias: torch.Tensor) -> torch.Tensor:
        """The (x, t)-invariant conditioning term added after the init conv."""
        B, T = cond_fea.shape[:2]
        cf = self._adapt(self.cond_adaptor, cond_fea.to(self.compute_dtype))
        cf = self.cond_temporal_attn(cf, pos_bias)
        cf = interpolate_bilinear(cf.reshape(B * T, *cf.shape[2:]), (H, W))
        cf = cf.reshape(B, T, H, W, -1)
        return conv_frames(cf, self.init_conv.weight[:, self.channels:], None, self.compute_dtype,
                           padding=self.init_pad)

    @span("unet.forward")
    def forward(self, x, time, cond_frames, cond_fea=None, cond_cache=None,
                cond_only: bool = False, cond=None, null_cond_mask=None, shard=None):
        """x (B, tp, h, w, C) noisy latents, cond_frames (B, tc, h, w, C),
        cond_fea (B, tc+tp, hf, wf, cond_feature_dim) -> (B, tp, h, w, 3) float32.
        cond_only returns the conditioning term to pass back as cond_cache
        (the adaptor family only: the trajwarp conditioning depends on x).
        With ``cond_dim``: cond (B, cond_dim) is the condition embedding
        (None: the null embedding), null_cond_mask (B,) bool replaces a
        sample's condition with the null embedding. With `shard` (a
        ``parallel.SpatialMesh``), x, cond_frames, a given cond_cache and the
        result hold the shard's rows of h; cond_fea is whole."""
        tc, tp = cond_frames.shape[1], x.shape[1]
        if (tc, tp) != (self.cond_num, self.pred_num):
            raise ValueError(f"frames (cond, pred) = {(tc, tp)}, the UNet was built for "
                             f"{(self.cond_num, self.pred_num)}")
        dtype = self.compute_dtype
        x = torch.cat([cond_frames, x], dim=1).to(dtype)
        B, T, H, W, _ = x.shape
        if shard is not None:
            H = self._global_h(H, shard)
        pos_bias = self._pos_bias(T, H, W)

        w0, b0 = self.init_conv.weight, self.init_conv.bias
        if self.traj:
            if cond_only or cond_cache is not None:
                raise ValueError("the trajwarp conditioning depends on x: it has no cond cache")
            nc = self.init_noise_conv
            x = conv_frames(x, nc.weight, nc.bias, dtype, padding=self.init_pad, shard=shard)
            f = self.init_traj(x[:, tc:], cond_fea, shard=shard)
            if shard is None:
                f = interpolate_bilinear(f.reshape(B * T, *f.shape[2:]), (H, W))
                f = f.reshape(B, T, H, W, -1)
            else:
                f = _traj_features_rows(f, cond_fea, tc, shard, (H, W))
            x = torch.cat([x, f], dim=-1)
            x = conv_frames(x, w0, b0, dtype, padding=self.init_pad, shard=shard)
        elif self.use_ref_features:
            if cond_cache is None:  # on the global H, once a sampler call: cut to the shard
                cond_cache = self.cond_stream(cond_fea, H, W, pos_bias)
                if shard is not None:
                    cond_cache = shard.slice_h(cond_cache)
            if cond_only:
                return cond_cache
            x = conv_frames(x, w0[:, :self.channels], b0, dtype, padding=self.init_pad,
                            shard=shard) + cond_cache
        else:
            x = conv_frames(x, w0, b0, dtype, padding=self.init_pad, shard=shard)

        r = x
        x = self.init_temporal_attn(x, pos_bias, shard)

        tm = self.time_mlp
        t_emb = F.linear(tm[0](time), tm[1].weight.float(), tm[1].bias.float())
        t_emb = F.linear(tm[2](t_emb), tm[3].weight.float(), tm[3].bias.float())
        if self.cond_dim is not None:
            null = (self.null_cond_emb.float() if self.null_cond_emb is not None
                    else t_emb.new_zeros(1, self.cond_dim))
            cond = null.expand(B, -1) if cond is None else cond.to(t_emb)
            if null_cond_mask is not None:
                cond = torch.where(null_cond_mask.to(t_emb.device)[:, None], null, cond)
            t_emb = torch.cat([t_emb, cond], dim=-1)

        hs, sh = [], shard
        for res1, stw1, res2, stw2, adaptor, tattn, down in self.downs:
            x = res2(res1(x, t_emb, sh), t_emb, sh)
            x = self._adapt(adaptor, stw2(stw1(x, sh), sh), sh)
            x = tattn(x, pos_bias, sh)
            hs.append(x)
            x = _call(down, x, sh)
        x = self.mid_block1(x, t_emb, sh)
        x = self._adapt(self.mid_adaptor, self.mid_attn2(self.mid_attn1(x, sh), sh), sh)
        x = self.mid_block2(x, t_emb, sh)
        for res1, stw1, res2, stw2, adaptor, tattn, up in self.ups:
            x = torch.cat([x, hs.pop()], dim=-1)
            x = res2(res1(x, t_emb, sh), t_emb, sh)
            x = self._adapt(adaptor, stw2(stw1(x, sh), sh), sh)
            x = tattn(x, pos_bias, sh)
            x = _call(up, x, sh)
        x = torch.cat([x, r], dim=-1)
        out = torch.cat([proj(block(x, shard=sh)) for block, proj in (self.final_conv,
                                                                       self.occlusion_map)], dim=-1)
        if self.use_final_activation:
            out = torch.tanh(out)
        return out[:, tc:].float()
