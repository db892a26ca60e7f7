"""Stage-1 (LFAE) training model: reconstruction + multi-scale perceptual +
TPS equivariance losses (port of extdm_tpu/models/lfae/recon_model.py).

As in the JAX package, the VGG19 of the perceptual loss is one of the
model's trained modules: its parameters get gradients (the real frame's
features are not detached) and the optimizer updates them. The reference
froze it; that divergence is the JAX package's and is kept here.

``dtype`` is the compute type of every module (None: float32; the AE job's
``--bf16`` passes bfloat16, as JAX's ``ReconstructionModel(dtype=...)``):
parameters and BatchNorm statistics stay float32, each conv casts its input
and weights, BatchNorm reduces in float32. There is no second copy of the
model: the optimizer updates the float32 parameters that the forward casts.
The losses come out in the type their last operation gives, as in the JAX
package: the perceptual loss in the compute type (means of VGG features),
the others float32.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from extdm_tpu_torch.models.lfae.bg_predictor import BGMotionPredictor
from extdm_tpu_torch.models.lfae.generator import Generator
from extdm_tpu_torch.models.lfae.region_predictor import RegionPredictor
from extdm_tpu_torch.models.lfae.transform import (TPSTransform, jacobian, transform_frame,
                                                   warp_coordinates)
from extdm_tpu_torch.models.lfae.vgg import Vgg19Features
from extdm_tpu_torch.ops.antialias import antialias_downsample
from extdm_tpu_torch.ops.eigh2x2 import inv_2x2


class ReconstructionModel(nn.Module):
    def __init__(self, region_predictor_cfg: dict, bg_predictor_cfg: dict, generator_cfg: dict,
                 num_regions: int, num_channels: int = 3,
                 scales: Sequence[float] = (1.0, 0.5, 0.25), loss_weights: Optional[dict] = None,
                 transform_params: Optional[dict] = None, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.region_predictor = RegionPredictor(num_regions=num_regions,
                                                num_channels=num_channels, dtype=dtype,
                                                **region_predictor_cfg)
        self.bg_predictor = BGMotionPredictor(num_channels=num_channels, dtype=dtype,
                                              **bg_predictor_cfg)
        self.generator = Generator(num_regions=num_regions, num_channels=num_channels,
                                   dtype=dtype, **generator_cfg)
        self.scales = tuple(scales)
        self.loss_weights = dict(loss_weights or {})
        self.transform_params = dict(transform_params or {})
        self.vgg = (Vgg19Features(dtype) if sum(self.loss_weights.get("perceptual", [0])) != 0
                    else None)

    @property
    def uses_tps(self) -> bool:
        """Whether the losses need a TPS draw (an equivariance weight is set)."""
        w = self.loss_weights
        return (w.get("equivariance_shift", 0) + w.get("equivariance_affine", 0)) != 0

    def forward(self, source: torch.Tensor, driving: torch.Tensor,
                tps: Optional[TPSTransform] = None) -> Tuple[Dict[str, torch.Tensor], Dict]:
        """source, driving (B, H, W, C) in [0, 1]; `tps` is the random
        transform of the equivariance losses (needed when ``uses_tps``).
        Returns (losses, generated), each loss already weighted."""
        weights = self.loss_weights
        source_params = self.region_predictor(source)
        driving_params = self.region_predictor(driving)
        bg_params = self.bg_predictor(source, driving)
        generated = dict(self.generator(source, driving_params, source_params, bg_params))
        generated["source_region_params"] = source_params
        generated["driving_region_params"] = driving_params
        losses: Dict[str, torch.Tensor] = {}

        percep_w = weights.get("perceptual", [])
        if self.vgg is not None and sum(percep_w) != 0:
            total = 0.0
            for scale in self.scales:
                side = min(driving.shape[1], driving.shape[2]) * scale
                if side < 16:
                    # relu5_1 sits at stride 16: a smaller input pools to an
                    # empty map whose mean is NaN, poisoning every step
                    raise ValueError(
                        f"perceptual scale {scale} on {driving.shape[1]}x{driving.shape[2]} "
                        f"frames gives a {side:g}px VGG input (< 16px); drop the scale or use "
                        f"larger frames")
                x_feats = self.vgg(antialias_downsample(generated["prediction"], scale))
                y_feats = self.vgg(antialias_downsample(driving, scale))
                for w, xf, yf in zip(percep_w, x_feats, y_feats):
                    total = total + w * (xf - yf).abs().mean()
            losses["perceptual"] = total

        eq_shift_w = weights.get("equivariance_shift", 0)
        eq_affine_w = weights.get("equivariance_affine", 0)
        if self.uses_tps:
            if tps is None:
                raise ValueError("the equivariance losses need a TPS draw (tps=...)")
            transformed_frame = transform_frame(tps, driving)
            transformed_params = self.region_predictor(transformed_frame)
            generated["transformed_frame"] = transformed_frame
            generated["transformed_region_params"] = transformed_params
            if eq_shift_w != 0:
                warped_shift = warp_coordinates(tps, transformed_params["shift"])
                losses["equivariance_shift"] = eq_shift_w * (
                    driving_params["shift"] - warped_shift).abs().mean()
            if eq_affine_w != 0:
                jac = jacobian(tps, transformed_params["shift"])
                value = inv_2x2(driving_params["affine"]) @ (jac @ transformed_params["affine"])
                if self.generator.pixelwise_flow_predictor is not None and (
                        self.generator.revert_axis_swap):
                    value = value * torch.sign(value[:, :, 0:1, 0:1])
                eye = torch.eye(2, dtype=value.dtype, device=value.device)
                losses["equivariance_affine"] = eq_affine_w * (eye - value).abs().mean()

        rec_w = weights.get("reconstruction", 0)
        if rec_w != 0:
            losses["reconstruction"] = rec_w * ((generated["prediction"] - driving) ** 2).mean()
        return losses, generated
