"""Plain float32 LFAE (the frozen stage-1 latent flow auto-encoder of ExtDM):
region predictor, background motion predictor, dense flow predictor and
the flow-warping generator, channels-last (B, H, W, C).

It follows the semantics of the published LFAE (the region-based motion
model of "Motion Representations for Articulated Animation" as ExtDM uses
it) in plain PyTorch: ``torch.nn.functional`` convolutions, batch norms
with running statistics (the LFAE is frozen), ``F.grid_sample`` with
``align_corners=True``. Parameter names are the state-dict keys of the
reference checkpoints, so one state dict loads here and into the program.
Nothing here is imported from the program.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


# --- small helpers ----------------------------------------------------------
def coordinate_grid(h: int, w: int, device=None) -> torch.Tensor:
    """(h, w, 2) grid of (x, y) in [-1, 1]; channel 0 runs along the width."""
    x = torch.linspace(-1.0, 1.0, w, device=device) if w > 1 else torch.zeros(1, device=device)
    y = torch.linspace(-1.0, 1.0, h, device=device) if h > 1 else torch.zeros(1, device=device)
    return torch.stack([x[None, :].expand(h, w), y[:, None].expand(h, w)], dim=-1)


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def warp(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear backward warp of (B, H, W, C) by a (B, Ho, Wo, 2) grid, zeros outside."""
    return to_nhwc(F.grid_sample(to_nchw(image), grid, mode="bilinear", padding_mode="zeros",
                                 align_corners=True))


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """(B, H, W, C) -> (B, size[0], size[1], C), align_corners=False, no antialias."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    return to_nhwc(F.interpolate(to_nchw(x), size=tuple(size), mode="bilinear",
                                 align_corners=False))


def antialias_downsample(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Gaussian blur (sigma = (1/scale - 1) / 2, 4 sigma each side) and
    subsample by 1/scale, in one strided depthwise convolution."""
    if scale == 1.0:
        return x
    stride = int(round(1.0 / scale))
    sigma = (1.0 / scale - 1.0) / 2.0
    ksize = 2 * round(sigma * 4) + 1
    xs = np.arange(ksize, dtype=np.float64)
    k1 = np.exp(-((xs - (ksize - 1) / 2.0) ** 2) / (2.0 * sigma ** 2))
    k2 = np.outer(k1, k1)
    k2 = k2 / k2.sum()
    C = x.shape[-1]
    kernel = torch.as_tensor(k2, dtype=x.dtype, device=x.device).expand(C, 1, ksize, ksize)
    pad = ksize // 2
    xp = F.pad(to_nchw(x), (pad, pad, pad, pad))
    return to_nhwc(F.conv2d(xp, kernel, stride=stride, groups=C))


def eigh_2x2(covar: torch.Tensor, eps: float = 1e-12):
    """Eigenvectors (columns, the larger eigenvalue's first) and eigenvalues
    of symmetric 2x2 matrices, in the closed form the LFAE's region affines
    are defined with (the first eigenvector from whichever of its two forms
    avoids cancellation, the second its rotation by +90 degrees)."""
    a, c = covar[..., 0, 0], covar[..., 1, 1]
    b = 0.5 * (covar[..., 0, 1] + covar[..., 1, 0])
    root = torch.sqrt(torch.clamp(0.25 * (a - c) ** 2 + b * b, min=0.0) + eps)
    lam1, lam2 = 0.5 * (a + c) + root, 0.5 * (a + c) - root
    first = a < c
    vx = torch.where(first, b, lam1 - c)
    vy = torch.where(first, lam1 - a, b)
    n2 = vx * vx + vy * vy
    flat = n2 < eps
    vx = torch.where(flat, torch.ones_like(vx), vx)
    vy = torch.where(flat, torch.zeros_like(vy), vy)
    n = torch.sqrt(torch.where(flat, torch.ones_like(n2), n2) + eps)
    vx, vy = vx / n, vy / n
    u = torch.stack([torch.stack([vx, -vy], -1), torch.stack([vy, vx], -1)], -2)
    return u, torch.stack([lam1, lam2], -1)


def inverse_2x2(m: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Adjugate over determinant; a determinant under eps in size is moved to +-eps."""
    a, b, c, d = m[..., 0, 0], m[..., 0, 1], m[..., 1, 0], m[..., 1, 1]
    det = a * d - b * c
    det = torch.where(det.abs() < eps, torch.sign(det) * eps + (det == 0) * eps, det)
    adj = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2)
    return adj / det[..., None, None]


def gaussian_heatmap(center: torch.Tensor, covar: torch.Tensor, size) -> torch.Tensor:
    """exp(-d^T covar^-1 d / 2) over the grid: (B, K, h, w)."""
    grid = coordinate_grid(*size, device=center.device)
    d = grid[None, None] - center[:, :, None, None, :]
    inv = torch.linalg.inv(covar)[:, :, None, None]
    q = (d[..., :, None] * inv).sum(-2)  # d^T inv
    return torch.exp(-0.5 * (q * d).sum(-1))


# --- blocks -----------------------------------------------------------------------
class Conv2d(nn.Conv2d):
    """Convolution on channels-last tensors."""

    def __init__(self, cin: int, cout: int, k: int, padding: int = 0):
        super().__init__(cin, cout, k, padding=padding)

    def forward(self, x):
        return to_nhwc(super().forward(to_nchw(x)))


class BatchNorm(nn.BatchNorm2d):
    """Batch norm of the frozen LFAE: running statistics, channels-last."""

    def forward(self, x):
        return to_nhwc(F.batch_norm(to_nchw(x), self.running_mean, self.running_var,
                                    self.weight, self.bias, False, 0.0, self.eps))


class SameBlock2d(nn.Module):
    def __init__(self, cin: int, cout: int, k: int = 3):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, padding=k // 2)
        self.norm = BatchNorm(cout)

    def forward(self, x):
        return F.relu(self.norm(self.conv(x)))


class DownBlock2d(SameBlock2d):
    def forward(self, x):
        return to_nhwc(F.avg_pool2d(to_nchw(super().forward(x)), 2))


class UpBlock2d(SameBlock2d):
    def forward(self, x):
        return super().forward(to_nhwc(F.interpolate(to_nchw(x), scale_factor=2,
                                                     mode="nearest")))


class ResBlock2d(nn.Module):
    def __init__(self, c: int, k: int = 3):
        super().__init__()
        self.norm1, self.conv1 = BatchNorm(c), Conv2d(c, c, k, padding=k // 2)
        self.norm2, self.conv2 = BatchNorm(c), Conv2d(c, c, k, padding=k // 2)

    def forward(self, x):
        h = self.conv1(F.relu(self.norm1(x)))
        return self.conv2(F.relu(self.norm2(h))) + x


def _features(be: int, mf: int, i: int) -> int:
    return min(mf, be * 2 ** i)


class Encoder(nn.Module):
    def __init__(self, be: int, cin: int, n: int, mf: int):
        super().__init__()
        chans = [cin] + [_features(be, mf, i + 1) for i in range(n)]
        self.down_blocks = nn.ModuleList(DownBlock2d(chans[i], chans[i + 1]) for i in range(n))

    def forward(self, x) -> List[torch.Tensor]:
        outs = [x]
        for blk in self.down_blocks:
            outs.append(blk(outs[-1]))
        return outs


class Decoder(nn.Module):
    def __init__(self, be: int, cin: int, n: int, mf: int):
        super().__init__()
        self.up_blocks = nn.ModuleList(
            UpBlock2d((1 if i == n - 1 else 2) * _features(be, mf, i + 1), _features(be, mf, i))
            for i in reversed(range(n)))
        self.out_filters = be + cin

    def forward(self, skips):
        skips = list(skips)
        out = skips.pop()
        for blk in self.up_blocks:
            out = torch.cat([blk(out), skips.pop()], dim=-1)
        return out


class Hourglass(nn.Module):
    def __init__(self, be: int, cin: int, n: int, mf: int):
        super().__init__()
        self.encoder = Encoder(be, cin, n, mf)
        self.decoder = Decoder(be, cin, n, mf)
        self.out_filters = self.decoder.out_filters

    def forward(self, x):
        return self.decoder(self.encoder(x))


# --- the three networks -------------------------------------------------------------
class RegionPredictor(nn.Module):
    """K soft region heatmaps; each region's mean (shift) and, PCA based, its
    covariance and the affine sqrt of it."""

    def __init__(self, num_regions, num_channels, block_expansion, max_features, num_blocks,
                 temperature, scale_factor, pca_based=True, pad=0, **_):
        super().__init__()
        if not pca_based:
            raise NotImplementedError("the reference covers the PCA-based region predictor")
        self.temperature, self.scale_factor = temperature, scale_factor
        self.predictor = Hourglass(block_expansion, num_channels, num_blocks, max_features)
        self.regions = Conv2d(self.predictor.out_filters, num_regions, 7, padding=pad)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        x = antialias_downsample(x, self.scale_factor)
        logits = self.regions(self.predictor(x))
        B, h, w, K = logits.shape
        region = torch.softmax(logits.reshape(B, h * w, K) / self.temperature, dim=1)
        region = region.reshape(B, h, w, K)
        grid = coordinate_grid(h, w, x.device)
        shift = torch.einsum("bhwk,hwc->bkc", region, grid)
        d = grid[None, :, :, None, :] - shift[:, None, None, :, :]
        covar = torch.einsum("bhwki,bhwkj,bhwk->bkij", d, d, region)
        u, s = eigh_2x2(covar)
        affine = u * torch.sqrt(torch.clamp(s, min=0.0) + 1e-12)[..., None, :]
        return {"shift": shift, "covar": covar, "affine": affine}


class BGMotionPredictor(nn.Module):
    """A 3x3 background transform per (source, driving) pair."""

    OUT = {"affine": 6, "perspective": 8}

    def __init__(self, num_channels, block_expansion, max_features, num_blocks, bg_type):
        super().__init__()
        if bg_type not in self.OUT:
            raise NotImplementedError(f"bg_type {bg_type!r}")
        self.bg_type = bg_type
        self.encoder = Encoder(block_expansion, 2 * num_channels, num_blocks, max_features)
        self.fc = nn.Linear(_features(block_expansion, max_features, num_blocks),
                            self.OUT[bg_type])

    def forward(self, source, driving):
        B = source.shape[0]
        pooled = self.encoder(torch.cat([source, driving], dim=-1))[-1].mean(dim=(1, 2))
        pred = self.fc(pooled)
        out = torch.eye(3, device=source.device).repeat(B, 1, 1)
        out[:, :2, :] = pred[:, :6].reshape(B, 2, 3)
        if self.bg_type == "perspective":
            out[:, 2, :2] = pred[:, 6:]
        return out


class PixelwiseFlowPredictor(nn.Module):
    """Dense flow as a softmax mix of K region motions and the background's,
    from heatmap differences and the source warped by each motion; an
    occlusion map beside it."""

    def __init__(self, num_regions, num_channels, block_expansion, max_features, num_blocks,
                 scale_factor, use_deformed_source=True, use_covar_heatmap=True,
                 estimate_occlusion_map=True, revert_axis_swap=True):
        super().__init__()
        if not (use_deformed_source and use_covar_heatmap and estimate_occlusion_map):
            raise NotImplementedError("the reference covers ExtDM's flow predictor settings")
        self.num_regions, self.scale_factor = num_regions, scale_factor
        self.revert_axis_swap = revert_axis_swap
        self.hourglass = Hourglass(block_expansion, (num_regions + 1) * (num_channels + 1),
                                   num_blocks, max_features)
        self.mask = Conv2d(self.hourglass.out_filters, num_regions + 1, 7, padding=3)
        self.occlusion = Conv2d(self.hourglass.out_filters, 1, 7, padding=3)

    def forward(self, source, driving, src, bg):
        source = antialias_downsample(source, self.scale_factor)
        B, h, w, C = source.shape
        K1 = self.num_regions + 1
        heat = (gaussian_heatmap(driving["shift"], driving["covar"], (h, w))
                - gaussian_heatmap(src["shift"], src["covar"], (h, w)))
        heat = torch.cat([torch.zeros_like(heat[:, :1]), heat], dim=1)  # (B, K+1, h, w)
        identity = coordinate_grid(h, w, source.device)[None, None]
        coord = identity - driving["shift"][:, :, None, None, :]
        affine = src["affine"] @ inverse_2x2(driving["affine"])
        if self.revert_axis_swap:
            affine = affine * torch.sign(affine[:, :, 0:1, 0:1])
        coord = (affine[:, :, None, None] * coord[..., None, :]).sum(-1)
        region_grids = coord + src["shift"][:, :, None, None, :]
        hom = torch.cat([identity, torch.ones_like(identity[..., :1])], dim=-1)
        bgh = (bg[:, None, None, None] * hom[..., None, :]).sum(-1)  # (B, 1, h, w, 3)
        bg_grid = bgh[..., :2] / (bgh[..., 2:3] + 1e-10)
        motions = torch.cat([bg_grid, region_grids], dim=1)  # (B, K+1, h, w, 2)
        copies = source[:, None].expand(B, K1, h, w, C).reshape(B * K1, h, w, C)
        deformed = warp(copies, motions.reshape(B * K1, h, w, 2)).reshape(B, K1, h, w, C)
        feats = torch.cat([heat[..., None], deformed], dim=-1)  # per region [heat, C]
        pred = self.hourglass(feats.permute(0, 2, 3, 1, 4).reshape(B, h, w, K1 * (C + 1)))
        mask = torch.softmax(self.mask(pred), dim=-1)
        flow = (motions * mask.permute(0, 3, 1, 2)[..., None]).sum(1)
        return {"optical_flow": flow, "occlusion_map": torch.sigmoid(self.occlusion(pred))}


class Generator(nn.Module):
    """Encoder, bottleneck and decoder whose skips and bottleneck are warped
    by the flow and masked by the occlusion; the output blends the warped
    source in."""

    def __init__(self, num_regions, num_channels, block_expansion, max_features,
                 num_down_blocks, num_bottleneck_blocks, pixelwise_flow_predictor_params,
                 revert_axis_swap=True, skips=True):
        super().__init__()
        if not skips:
            raise NotImplementedError("the reference covers the generator with skips")
        self.pixelwise_flow_predictor = PixelwiseFlowPredictor(
            num_regions=num_regions, num_channels=num_channels,
            revert_axis_swap=revert_axis_swap, **pixelwise_flow_predictor_params)
        f = lambda i: _features(block_expansion, max_features, i)  # noqa: E731
        self.first = SameBlock2d(num_channels, block_expansion, 7)
        self.down_blocks = nn.ModuleList(DownBlock2d(f(i), f(i + 1))
                                         for i in range(num_down_blocks))
        self.up_blocks = nn.ModuleList(UpBlock2d(f(num_down_blocks - i), f(num_down_blocks - i - 1))
                                       for i in range(num_down_blocks))
        self.bottleneck = nn.Sequential()
        for i in range(num_bottleneck_blocks):
            self.bottleneck.add_module(f"r{i}", ResBlock2d(f(num_down_blocks)))
        self.final = Conv2d(block_expansion, num_channels, 7, padding=3)

    def encode(self, image):
        out = self.first(image)
        skips = [out]
        for blk in self.down_blocks:
            out = blk(out)
            skips.append(out)
        return out, skips

    @staticmethod
    def _occlude(deformed, occlusion, previous=None):
        occlusion = resize_bilinear(occlusion, deformed.shape[1:3])
        if previous is None:
            return deformed * occlusion
        return deformed * occlusion + previous * (1 - occlusion)

    def decode(self, feat, skips, image, flow, occlusion):
        """Pixels from the source's features, its skips, the flow and the occlusion."""
        def deform(x):
            return warp(x, resize_bilinear(flow, x.shape[1:3]))

        out = self._occlude(deform(feat), occlusion)
        out = self.bottleneck(out)
        for i, blk in enumerate(self.up_blocks):
            out = blk(self._occlude(deform(skips[-(i + 1)]), occlusion, out))
        out = self._occlude(deform(skips[0]), occlusion, out)
        out = torch.sigmoid(self.final(out))
        warped = deform(image)
        return self._occlude(warped, occlusion, out), warped


class LFAE(nn.Module):
    """The frozen stage-1 bundle as the DM uses it."""

    def __init__(self, flow_params: dict):
        super().__init__()
        fp = flow_params
        self.region_predictor = RegionPredictor(num_regions=fp["num_regions"],
                                                num_channels=fp["num_channels"],
                                                **fp["region_predictor_params"])
        self.bg_predictor = BGMotionPredictor(num_channels=fp["num_channels"],
                                              **fp["bg_predictor_params"])
        self.generator = Generator(num_regions=fp["num_regions"], num_channels=fp["num_channels"],
                                   revert_axis_swap=fp.get("revert_axis_swap", True),
                                   **fp["generator_params"])

    def encode_video(self, video: torch.Tensor, tc: int) -> Dict[str, torch.Tensor]:
        """(B, T, H, W, C) -> flow (B, T, h, w, 2) and occlusion (B, T, h, w, 1)
        of every frame against the reference frame tc - 1."""
        B, T = video.shape[:2]
        ref = video[:, tc - 1]
        frames = video.reshape(B * T, *video.shape[2:])
        src = self.region_predictor(ref)
        drv = self.region_predictor(frames)
        ref_rep = ref.repeat_interleave(T, dim=0)
        bg = self.bg_predictor(ref_rep, frames)
        src = {k: v.repeat_interleave(T, dim=0) for k, v in src.items()}
        motion = self.generator.pixelwise_flow_predictor(ref_rep, drv, src, bg)
        return {k: v.reshape(B, T, *v.shape[1:]) for k, v in
                (("flow", motion["optical_flow"]), ("conf", motion["occlusion_map"]))}

    def ref_features(self, video: torch.Tensor, tc: int, tp: int) -> torch.Tensor:
        """Bottleneck features of the cond frames 0..tc-2, then the reference
        frame's repeated 1 + tp times: (B, tc + tp, hf, wf, Cf)."""
        B = video.shape[0]
        feats, _ = self.generator.encode(video[:, :tc].reshape(B * tc, *video.shape[2:]))
        feats = feats.reshape(B, tc, *feats.shape[1:])
        return torch.cat([feats[:, :tc - 1], feats[:, tc - 1:].repeat_interleave(1 + tp, dim=1)],
                         dim=1)

    def decode_flows(self, ref: torch.Tensor, flow: torch.Tensor,
                     conf: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Frames (B, T, H, W, C) from the reference frame and T flows and occlusions."""
        B, T = flow.shape[:2]
        feat, skips = self.generator.encode(ref)
        rep = lambda t: t.repeat_interleave(T, dim=0)  # noqa: E731
        out, warped = self.generator.decode(rep(feat), [rep(s) for s in skips], rep(ref),
                                            flow.reshape(B * T, *flow.shape[2:]),
                                            conf.reshape(B * T, *conf.shape[2:]))
        return {"out_vid": out.reshape(B, T, *out.shape[1:]),
                "warped_vid": warped.reshape(B, T, *warped.shape[1:])}
