"""LPIPS perceptual distance with an AlexNet backbone (port of
extdm_tpu/metrics/lpips.py): inputs in [-1, 1], the scaling layer, AlexNet
relu1-5 features, per-channel unit normalisation, squared differences
weighted by the non-negative 1x1 linear heads, each map upsampled to the
input size and averaged (spatial=True), and the 1 / 2 / 3 aggregations
(lpips2: the best, i.e. lowest, of n trajectories).

Parameter names are the ``lpips`` package's (``net.slice1.0.weight``,
``lin0.model.1.weight``, ...), so its AlexNet checkpoint loads unchanged.
No weight file exists here: without one ``LPIPSMetric`` uses a seeded
random init and reports ``pretrained: False`` (deterministic, not
comparable with published numbers).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from extdm_tpu_torch.models.dm.flow_diffusion import resolve_device

# (out channels, kernel, stride, padding, max-pool first) per AlexNet conv,
# and its index in torchvision's alexnet.features
ALEX_CFG = [(64, 11, 4, 2, False), (192, 5, 1, 2, True), (384, 3, 1, 1, True),
            (256, 3, 1, 1, False), (256, 3, 1, 1, False)]
ALEX_CONV_IDX = [0, 3, 6, 8, 10]
CHUNK = 512  # frames per forward


class AlexNetFeatures(nn.Module):
    """relu1 .. relu5 of torchvision's AlexNet.features, in lpips's slices;
    (B, 3, H, W) in, five NCHW maps out."""

    def __init__(self):
        super().__init__()
        c_in = 3
        for j, ((c, k, s, p, pool), i) in enumerate(zip(ALEX_CFG, ALEX_CONV_IDX)):
            sl = nn.Sequential()
            if pool:
                sl.add_module(str(i - 1), nn.MaxPool2d(3, 2))
            sl.add_module(str(i), nn.Conv2d(c_in, c, k, s, p))
            sl.add_module(str(i + 1), nn.ReLU())
            setattr(self, f"slice{j + 1}", sl)
            c_in = c

    def forward(self, x) -> List[torch.Tensor]:
        outs = []
        for j in range(len(ALEX_CFG)):
            x = getattr(self, f"slice{j + 1}")(x)
            outs.append(x)
        return outs


class ScalingLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("shift", torch.tensor([-0.030, -0.088, -0.188]).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor([0.458, 0.448, 0.450]).view(1, 3, 1, 1))

    def forward(self, x):
        return (x - self.shift) / self.scale


class NetLinLayer(nn.Module):
    """A 1x1 bias-free head behind dropout (identity in eval mode)."""

    def __init__(self, c_in: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(), nn.Conv2d(c_in, 1, 1, bias=False))


class LPIPS(nn.Module):
    """(B, H, W, 3) pairs in [-1, 1] -> (B,) distances."""

    def __init__(self, spatial: bool = True):
        super().__init__()
        self.spatial = spatial
        self.scaling_layer = ScalingLayer()
        self.net = AlexNetFeatures()
        for j, (c, *_) in enumerate(ALEX_CFG):
            setattr(self, f"lin{j}", NetLinLayer(c))

    def forward(self, x0, x1):
        H, W = x0.shape[1:3]
        f0 = self.net(self.scaling_layer(x0.permute(0, 3, 1, 2)))
        f1 = self.net(self.scaling_layer(x1.permute(0, 3, 1, 2)))
        total = 0.0
        for j, (a, b) in enumerate(zip(f0, f1)):
            # lpips normalize_tensor: eps outside the square root
            a = a / (torch.sqrt((a ** 2).sum(dim=1, keepdim=True)) + 1e-10)
            b = b / (torch.sqrt((b ** 2).sum(dim=1, keepdim=True)) + 1e-10)
            w = getattr(self, f"lin{j}").model[1].weight.abs()  # heads are non-negative
            val = F.conv2d((a - b) ** 2, w)
            if self.spatial:
                total = total + F.interpolate(val, size=(H, W), mode="bilinear",
                                              align_corners=False)
            else:
                total = total + val.mean(dim=(2, 3), keepdim=True)
        return total.mean(dim=(1, 2, 3))


def random_lpips(seed: int = 0, spatial: bool = True) -> LPIPS:
    """LPIPS with a seeded random init: PyTorch's default conv init and heads
    uniform in [0, 0.1) (the flax module's initializer)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = LPIPS(spatial)
        for j in range(len(ALEX_CFG)):
            nn.init.uniform_(getattr(model, f"lin{j}").model[1].weight, 0.0, 0.1)
    return model


class LPIPSMetric:
    """``LPIPSMetric(state_dict=None, seed=0, spatial=True, device="cuda")``:
    the lpips package's AlexNet state dict, or a seeded random init."""

    def __init__(self, state_dict: Optional[dict] = None, seed: int = 0, spatial: bool = True,
                 device="cuda"):
        self.device = resolve_device(device)
        self.pretrained = state_dict is not None
        self.model = random_lpips(seed, spatial)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.model = self.model.to(self.device).eval().requires_grad_(False)

    @torch.no_grad()
    def _video_matrix(self, videos1, videos2) -> torch.Tensor:
        """(B, T) distances; videos (B, T, H, W, C) in [0, 1]."""
        v1 = torch.as_tensor(videos1).to(self.device, torch.float32) * 2.0 - 1.0
        v2 = torch.as_tensor(videos2).to(self.device, torch.float32) * 2.0 - 1.0
        B, T = v1.shape[:2]
        flat1, flat2 = v1.reshape((B * T,) + v1.shape[2:]), v2.reshape((B * T,) + v2.shape[2:])
        out = torch.cat([self.model(flat1[i:i + CHUNK], flat2[i:i + CHUNK])
                         for i in range(0, B * T, CHUNK)])
        return out.reshape(B, T)

    def calculate_lpips1(self, videos1, videos2) -> Tuple[dict, dict]:
        mat = self._video_matrix(videos1, videos2).double().cpu().numpy()
        per_video = mat.mean(axis=1)
        return ({"lpips": per_video.mean(), "lpips_per_frame": mat.mean(axis=0)},
                {"lpips": per_video.std(), "lpips_per_frame": mat.std(axis=0)})

    def calculate_lpips2(self, videos1, videos2, num_sample: int) -> float:
        mat = self._video_matrix(videos1, videos2).mean(dim=1).reshape(-1, num_sample)
        return float(mat.min(dim=1).values.mean())

    def calculate_lpips3(self, videos1, videos2) -> np.ndarray:
        return self._video_matrix(videos1, videos2).cpu().numpy()
