"""FVD, the Fréchet distance between I3D features of two sets of videos
(port of extdm_tpu/metrics/fvd.py):
- ``preprocess_videos``: bilinear resize of the shorter side to 224
  (align_corners=False, no antialias), centre crop, [0, 1] -> [-1, 1];
- ``I3DExtractor``: the I3D's 400-d pre-softmax features, on the device;
- ``frechet_distance``: means and covariances, scipy's ``sqrtm`` on the
  host in float64;
- ``calculate_fvd1`` (from videos), ``calculate_fvd2`` (from features),
  ``get_feats`` and ``best_trajectory_by_feature_distance`` (best of n by
  the L1 distance of I3D features).

No I3D weight file exists here: without a state dict ``I3DExtractor`` uses a
seeded random (He) init and reports ``pretrained: False`` (deterministic,
not comparable with published numbers).
"""
from __future__ import annotations

import math
import warnings
from typing import Optional, Tuple

import numpy as np
import torch
from scipy.linalg import sqrtm

from extdm_tpu_torch.metrics.i3d import InceptionI3d
from extdm_tpu_torch.models.dm.flow_diffusion import resolve_device
from extdm_tpu_torch.ops.resize import interpolate_bilinear


def preprocess_videos(videos: torch.Tensor, resolution: int = 224) -> torch.Tensor:
    """(B, T, H, W, C) in [0, 1] -> (B, T, 224, 224, C) in [-1, 1]."""
    B, T, H, W, C = videos.shape
    scale = resolution / min(H, W)
    target = (resolution, math.ceil(W * scale)) if H < W else (math.ceil(H * scale), resolution)
    flat = interpolate_bilinear(videos.reshape(B * T, H, W, C), target)
    h0, w0 = (target[0] - resolution) // 2, (target[1] - resolution) // 2
    flat = flat[:, h0:h0 + resolution, w0:w0 + resolution]
    return (flat.reshape(B, T, resolution, resolution, C) - 0.5) * 2.0


def random_i3d(seed: int = 0) -> InceptionI3d:
    """InceptionI3d with a seeded He init of its convolutions: at PyTorch's
    default init the signal fades through the ~60 layers and every video
    gets almost the same features."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = InceptionI3d()
        for m in model.modules():
            if isinstance(m, torch.nn.Conv3d):
                torch.nn.init.kaiming_normal_(m.weight, nonlinearity="relu")
    return model


class I3DExtractor:
    """``I3DExtractor(state_dict=None, seed=0, device="cuda")``: the reference
    pytorch_i3d state dict, or a seeded random init."""

    def __init__(self, state_dict: Optional[dict] = None, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.pretrained = state_dict is not None
        self.model = random_i3d(seed)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.model = self.model.to(self.device).eval().requires_grad_(False)

    @torch.no_grad()
    def get_feats(self, videos, bs: int = 10) -> np.ndarray:
        """videos (N, T, H, W, C) in [0, 1] -> (N, 400) float32 features."""
        videos = torch.as_tensor(videos)
        feats = []
        for i in range(0, videos.shape[0], bs):
            chunk = videos[i:i + bs].to(self.device, torch.float32)
            feats.append(self.model(preprocess_videos(chunk)).cpu())
        return torch.cat(feats).numpy()


def compute_stats(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return feats.mean(axis=0), np.cov(feats, rowvar=False)


def frechet_distance(feats_fake: np.ndarray, feats_real: np.ndarray) -> float:
    """The stylegan-v protocol. Non-finite features give nan at once:
    LAPACK's Schur decomposition inside sqrtm can spin forever on NaN."""
    if not (np.isfinite(feats_fake).all() and np.isfinite(feats_real).all()):
        warnings.warn("frechet_distance: non-finite I3D features; returning nan (sqrtm on NaN "
                      "matrices can hang)")
        return float("nan")
    mu_gen, sigma_gen = compute_stats(feats_fake)
    mu_real, sigma_real = compute_stats(feats_real)
    m = float(np.square(mu_gen - mu_real).sum())
    if feats_fake.shape[0] > 1:
        s = sqrtm(np.dot(sigma_gen, sigma_real))
        return float(np.real(m + np.trace(sigma_gen + sigma_real - s * 2)))
    return float(np.real(m))


def calculate_fvd1(videos1, videos2, extractor: I3DExtractor, bs: int = 10) -> float:
    """FVD of two sets of (N, T, H, W, C) videos in [0, 1]."""
    return frechet_distance(extractor.get_feats(videos1, bs), extractor.get_feats(videos2, bs))


def calculate_fvd2(feats1: np.ndarray, feats2: np.ndarray) -> float:
    return frechet_distance(feats1, feats2)


def get_feats(videos, extractor: I3DExtractor, bs: int = 10) -> np.ndarray:
    return extractor.get_feats(videos, bs)


def best_trajectory_by_feature_distance(real_feats: np.ndarray, traj_feats: np.ndarray,
                                        num_sample: int) -> np.ndarray:
    """traj_feats (N * num_sample, F) grouped per real video -> the index in
    each group of the trajectory nearest its real video by L1 distance."""
    traj = traj_feats.reshape(real_feats.shape[0], num_sample, -1)
    return np.abs(traj - real_feats[:, None]).sum(-1).argmin(axis=1)
