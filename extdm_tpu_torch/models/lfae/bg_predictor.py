"""Background motion predictor: one 3x3 transform per (source, driving) pair
(port of extdm_tpu/models/lfae/bg_predictor.py)."""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from extdm_tpu_torch.nn.layers import Encoder

_N_OUT = {"shift": 2, "affine": 6, "perspective": 8}
_BIAS0 = {"shift": [0.0, 0.0], "affine": [1.0, 0.0, 0.0, 0.0, 1.0, 0.0],
          "perspective": [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0]}


class BGMotionPredictor(nn.Module):
    def __init__(self, num_channels: int = 3, block_expansion: int = 32,
                 max_features: int = 1024, num_blocks: int = 5, bg_type: str = "zero"):
        super().__init__()
        if bg_type not in ("zero", "shift", "affine", "perspective"):
            raise ValueError(f"unknown bg_type {bg_type!r}")
        self.bg_type = bg_type
        if bg_type != "zero":
            self.encoder = Encoder(block_expansion, 2 * num_channels, num_blocks, max_features)
            feats = min(max_features, block_expansion * 2 ** num_blocks)
            self.fc = nn.Linear(feats, _N_OUT[bg_type])
            nn.init.zeros_(self.fc.weight)
            with torch.no_grad():
                self.fc.bias.copy_(torch.tensor(_BIAS0[bg_type]))

    def forward(self, source: torch.Tensor, driving: torch.Tensor) -> torch.Tensor:
        """source, driving: (B, H, W, C) -> (B, 3, 3) float32."""
        B = source.shape[0]
        out = torch.eye(3, device=source.device).repeat(B, 1, 1)
        if self.bg_type == "zero":
            return out
        feats = self.encoder(torch.cat([source, driving], dim=-1))
        pooled = feats[-1].float().mean(dim=(1, 2))
        pred = F.linear(pooled, self.fc.weight.float(), self.fc.bias.float())
        if self.bg_type == "shift":
            out[:, :2, 2] = pred
            return out
        out[:, :2, :] = pred[:, :6].reshape(B, 2, 3)
        if self.bg_type == "perspective":
            out[:, 2, :2] = pred[:, 6:]
        return out
