"""Dense pixelwise flow from sparse region motions (port of
extdm_tpu/models/lfae/pixelwise_flow.py): Gaussian heatmap differences, K+1
sparse motions, K+1 warped copies of the source in one grid sample, hourglass
-> softmax mask -> weighted flow, optional occlusion head."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from extdm_tpu_torch.nn.layers import Conv2d, Hourglass
from extdm_tpu_torch.ops.antialias import antialias_downsample
from extdm_tpu_torch.ops.coords import (from_homogeneous, make_coordinate_grid, region2gaussian,
                                        to_homogeneous)
from extdm_tpu_torch.ops.eigh2x2 import inv_2x2
from extdm_tpu_torch.ops.fused_warp import grid_sample


class PixelwiseFlowPredictor(nn.Module):
    def __init__(self, num_regions: int, num_channels: int = 3, block_expansion: int = 64,
                 max_features: int = 1024, num_blocks: int = 5,
                 estimate_occlusion_map: bool = False, scale_factor: float = 1.0,
                 region_var: float = 0.01, use_covar_heatmap: bool = False,
                 use_deformed_source: bool = True, revert_axis_swap: bool = False):
        super().__init__()
        self.num_regions, self.scale_factor, self.region_var = num_regions, scale_factor, region_var
        self.use_covar_heatmap, self.use_deformed_source = use_covar_heatmap, use_deformed_source
        self.revert_axis_swap = revert_axis_swap
        in_features = (num_regions + 1) * ((num_channels if use_deformed_source else 0) + 1)
        self.hourglass = Hourglass(block_expansion, in_features, num_blocks, max_features)
        self.mask = Conv2d(self.hourglass.out_filters, num_regions + 1, 7, padding=3)
        self.occlusion = (Conv2d(self.hourglass.out_filters, 1, 7, padding=3)
                          if estimate_occlusion_map else None)

    def heatmap_representations(self, source, driving_params, source_params):
        h, w = source.shape[1:3]
        covar_d = driving_params["covar"] if self.use_covar_heatmap else self.region_var
        covar_s = source_params["covar"] if self.use_covar_heatmap else self.region_var
        heatmap = (region2gaussian(driving_params["shift"], covar_d, (h, w))
                   - region2gaussian(source_params["shift"], covar_s, (h, w)))
        return torch.cat([torch.zeros_like(heatmap[:, :1]), heatmap], dim=1)  # (B, K+1, h, w)

    def sparse_motions(self, source, driving_params, source_params, bg_params=None):
        """(B, K+1, h, w, 2) backward-warp grids: background first, then regions."""
        B, h, w = source.shape[:3]
        identity = make_coordinate_grid(h, w, source_params["shift"].dtype, source.device)[None, None]
        coord = identity - driving_params["shift"][:, :, None, None, :]
        if "affine" in driving_params:
            affine = source_params["affine"] @ inv_2x2(driving_params["affine"])
            if self.revert_axis_swap:
                affine = affine * torch.sign(affine[:, :, 0:1, 0:1])
            coord = torch.einsum("bkij,bkhwj->bkhwi", affine, coord)
        driving_to_source = coord + source_params["shift"][:, :, None, None, :]
        bg_grid = identity.expand(B, 1, h, w, 2)
        if bg_params is not None:
            bg_grid = from_homogeneous(
                torch.einsum("bij,bkhwj->bkhwi", bg_params, to_homogeneous(bg_grid)))
        return torch.cat([bg_grid, driving_to_source], dim=1)

    def forward(self, source, driving_params, source_params, bg_params=None
                ) -> Dict[str, torch.Tensor]:
        source = antialias_downsample(source, self.scale_factor).to(self.mask.weight.dtype)
        B, h, w, C = source.shape
        K1 = self.num_regions + 1
        heatmap = self.heatmap_representations(source, driving_params, source_params)
        sparse = self.sparse_motions(source, driving_params, source_params, bg_params)
        inp = heatmap[..., None].permute(0, 2, 3, 1, 4)  # (B, h, w, K+1, 1)
        if self.use_deformed_source:
            src = source[:, None].expand(B, K1, h, w, C).reshape(B * K1, h, w, C)
            deformed = grid_sample(src, sparse.reshape(B * K1, h, w, 2)).reshape(B, K1, h, w, C)
            # per region: [heat_k, deformed_k (C)], as the reference concatenates
            inp = torch.cat([inp, deformed.permute(0, 2, 3, 1, 4)], dim=-1)
        prediction = self.hourglass(inp.reshape(B, h, w, -1))
        mask = torch.softmax(self.mask(prediction).float(), dim=-1)  # (B, h, w, K+1)
        out = {"optical_flow": torch.einsum("bkhwc,bhwk->bhwc", sparse, mask)}
        if self.occlusion is not None:
            out["occlusion_map"] = torch.sigmoid(self.occlusion(prediction).float())
        return out
