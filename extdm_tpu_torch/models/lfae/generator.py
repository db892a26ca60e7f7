"""LFAE generator with flow-warped features (port of
extdm_tpu/models/lfae/generator.py). Modes used by the sampling path:
``bottle`` (encoder features), ``encode_flow`` (flow + occlusion only),
``encode_feats`` (features and skips of the reference frame) and
``flow_decode`` (decode given flows and pre-encoded features); ``full``
runs flow prediction and decode together. ``dtype`` is the compute type
(None: float32): the source image is cast to it on entry, the occlusion
blends run in the promoted type of their two inputs, and the pixel head's
sigmoid in float32 (so the final blend with the warped source is float32)."""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from extdm_tpu_torch.models.lfae.pixelwise_flow import PixelwiseFlowPredictor
from extdm_tpu_torch.nn.layers import Conv2d, DownBlock2d, ResBlock2d, SameBlock2d, UpBlock2d
from extdm_tpu_torch.ops.fused_warp import grid_sample
from extdm_tpu_torch.ops.resize import interpolate_bilinear


def deform_input(inp: torch.Tensor, optical_flow: torch.Tensor) -> torch.Tensor:
    """Warp (B, H, W, C) by a (B, h, w, 2) flow grid, resized bilinearly
    (align_corners=False) to (H, W) first if needed."""
    h, w = inp.shape[1:3]
    if optical_flow.shape[1:3] != (h, w):
        optical_flow = interpolate_bilinear(optical_flow, (h, w))
    return grid_sample(inp, optical_flow)


class Generator(nn.Module):
    def __init__(self, num_regions: int, num_channels: int = 3, block_expansion: int = 64,
                 max_features: int = 512, num_down_blocks: int = 2,
                 num_bottleneck_blocks: int = 6, skips: bool = True,
                 revert_axis_swap: bool = True,
                 pixelwise_flow_predictor_params: Optional[dict] = None, dtype=None):
        super().__init__()
        self.skips, self.revert_axis_swap = skips, revert_axis_swap
        self.compute_dtype = dtype or torch.float32
        self.pixelwise_flow_predictor = None
        if pixelwise_flow_predictor_params is not None:
            self.pixelwise_flow_predictor = PixelwiseFlowPredictor(
                num_regions=num_regions, num_channels=num_channels,
                revert_axis_swap=revert_axis_swap, dtype=dtype, **pixelwise_flow_predictor_params)
        self.first = SameBlock2d(num_channels, block_expansion, kernel_size=7, dtype=dtype)
        feats = lambda i: min(max_features, block_expansion * 2 ** i)  # noqa: E731
        self.down_blocks = nn.ModuleList(DownBlock2d(feats(i), feats(i + 1), dtype=dtype)
                                         for i in range(num_down_blocks))
        self.up_blocks = nn.ModuleList(UpBlock2d(feats(num_down_blocks - i),
                                                 feats(num_down_blocks - i - 1), dtype=dtype)
                                       for i in range(num_down_blocks))
        self.bottleneck = nn.Sequential()
        for i in range(num_bottleneck_blocks):
            self.bottleneck.add_module(f"r{i}", ResBlock2d(feats(num_down_blocks), dtype=dtype))
        self.final = Conv2d(block_expansion, num_channels, 7, padding=3, dtype=dtype)

    def _encode(self, source_image):
        out = self.first(source_image)
        skips = [out]
        for blk in self.down_blocks:
            out = blk(out)
            skips.append(out)
        return out, skips

    @staticmethod
    def _apply_optical(input_skip, motion, input_previous=None, deformed=None):
        if motion is None:
            return input_previous if input_previous is not None else input_skip
        occlusion = motion.get("occlusion_map")
        if deformed is None:
            deformed = deform_input(input_skip, motion["optical_flow"])
        if occlusion is None:
            return deformed
        if deformed.shape[1:3] != occlusion.shape[1:3]:
            occlusion = interpolate_bilinear(occlusion, deformed.shape[1:3])
        if input_previous is None:
            return deformed * occlusion.to(deformed.dtype)
        # blend in the promoted stream dtype, as the JAX package does
        bd = torch.promote_types(deformed.dtype, input_previous.dtype)
        occlusion = occlusion.to(bd)
        return deformed.to(bd) * occlusion + input_previous.to(bd) * (1 - occlusion)

    def _decode(self, out, skips, source_image, motion, output):
        deformed_skip0 = deformed_source = None
        if self.skips and motion is not None:
            # one warp for the two full-resolution inputs that share a flow
            cat = torch.cat([skips[0], source_image.to(skips[0].dtype)], dim=-1)
            d = deform_input(cat, motion["optical_flow"])
            c0 = skips[0].shape[-1]
            deformed_skip0, deformed_source = d[..., :c0], d[..., c0:]
            output["deformed"] = deformed_source
        out = self._apply_optical(out, motion)
        out = self.bottleneck(out)
        for i, blk in enumerate(self.up_blocks):
            if self.skips:
                out = self._apply_optical(skips[-(i + 1)], motion, input_previous=out)
            out = blk(out)
        if self.skips:
            out = self._apply_optical(skips[0], motion, input_previous=out,
                                      deformed=deformed_skip0)
        out = torch.sigmoid(self.final(out).float())
        if self.skips:
            out = self._apply_optical(source_image, motion, input_previous=out,
                                      deformed=deformed_source)
        output["prediction"] = out
        return output

    def forward(self, source_image, driving_region_params=None, source_region_params=None,
                bg_params=None, mode: str = "full", optical_flow=None, occlusion_map=None,
                feat=None, skips=None) -> Dict[str, torch.Tensor]:
        source_image = source_image.to(self.compute_dtype)
        if mode == "bottle":
            return {"bottle_neck_feat": self._encode(source_image)[0]}
        if mode == "encode_flow":
            return dict(self.pixelwise_flow_predictor(
                source_image, driving_region_params, source_region_params, bg_params))
        if mode == "encode_feats":
            out, sk = self._encode(source_image)
            return {"feat": out, "skips": tuple(sk)}
        if mode == "flow_decode":
            motion = {"optical_flow": optical_flow, "occlusion_map": occlusion_map}
            output = {}
            if not self.skips:
                output["deformed"] = deform_input(source_image, optical_flow)
            return self._decode(feat, list(skips), source_image, motion, output)
        if mode != "full":
            raise ValueError(f"unknown mode {mode!r}")
        out, sk = self._encode(source_image)
        output: Dict[str, torch.Tensor] = {"bottle_neck_feat": out}
        motion = None
        if self.pixelwise_flow_predictor is not None:
            motion = self.pixelwise_flow_predictor(
                source_image, driving_region_params, source_region_params, bg_params)
            if not self.skips:
                output["deformed"] = deform_input(source_image, motion["optical_flow"])
            output.update(motion)
        return self._decode(out, sk, source_image, motion, output)
