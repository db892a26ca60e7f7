"""Region predictor: hourglass -> K region heatmaps -> affine parameters
(port of extdm_tpu/models/lfae/region_predictor.py). The per-region 2x2 SVD
is the closed-form symmetric eigendecomposition. ``dtype`` is the compute
type of the hourglass and the heads (None: float32); the softmax, the
coordinate grid and the region statistics stay float32."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from extdm_tpu_torch.nn.layers import Conv2d, Hourglass
from extdm_tpu_torch.ops.antialias import antialias_downsample
from extdm_tpu_torch.ops.coords import make_coordinate_grid
from extdm_tpu_torch.ops.eigh2x2 import eigh_2x2, sqrt_symmetric_2x2


class RegionPredictor(nn.Module):
    def __init__(self, num_regions: int, num_channels: int = 3, block_expansion: int = 32,
                 max_features: int = 1024, num_blocks: int = 5, temperature: float = 0.1,
                 scale_factor: float = 1.0, pca_based: bool = True, estimate_affine: bool = True,
                 pad: int = 0, dtype=None):
        super().__init__()
        self.temperature, self.scale_factor = temperature, scale_factor
        self.pca_based, self.estimate_affine = pca_based, estimate_affine
        self.predictor = Hourglass(block_expansion, num_channels, num_blocks, max_features, dtype)
        self.regions = Conv2d(self.predictor.out_filters, num_regions, 7, padding=pad, dtype=dtype)
        if not pca_based and estimate_affine:
            self.jacobian = Conv2d(self.predictor.out_filters, 4, 7, padding=pad, dtype=dtype)
            nn.init.zeros_(self.jacobian.weight)
            with torch.no_grad():
                self.jacobian.bias.copy_(torch.tensor([1.0, 0.0, 0.0, 1.0]))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: (B, H, W, C) in [0, 1] -> shift (B, K, 2), covar/affine (B, K, 2, 2),
        heatmap (B, h, w, K); statistics in float32."""
        x = antialias_downsample(x, self.scale_factor)
        feature_map = self.predictor(x)
        prediction = self.regions(feature_map)
        B, h, w, K = prediction.shape
        region = torch.softmax(prediction.float().reshape(B, h * w, K) / self.temperature, dim=1)
        region = region.reshape(B, h, w, K)
        grid = make_coordinate_grid(h, w, region.dtype, x.device)
        shift = torch.einsum("bhwk,hwc->bkc", region, grid)
        params = {"shift": shift, "heatmap": region}
        if self.pca_based:
            diff = grid[None, :, :, None, :] - shift[:, None, None, :, :]
            covar = torch.einsum("bhwki,bhwkj,bhwk->bkij", diff, diff, region)
            u, s = eigh_2x2(covar)
            params.update(covar=covar, affine=sqrt_symmetric_2x2(covar), u=u,
                          d=torch.sqrt(torch.clamp(s, min=0.0)))
        elif self.estimate_affine:
            jac = torch.einsum("bhwk,bhwj->bkj", region, self.jacobian(feature_map).float())
            jac = jac.reshape(B, K, 2, 2)
            params.update(affine=jac, covar=jac @ jac.transpose(-1, -2))
        return params
