"""VGG19 features for the multi-scale perceptual loss (port of
extdm_tpu/models/lfae/vgg.py).

torchvision's ``vgg19().features`` up to relu5_1, as one ``nn.Sequential``
with torchvision's layer indices (so its ``features.{i}`` state-dict keys
load unchanged), split after relu1_1 / relu2_1 / relu3_1 / relu4_1 / relu5_1,
with ImageNet normalization in front. No pretrained weights are available
here, so the weights are random from the caller's seed (torchvision's
initialisation: He-normal over fan-out, zero bias): the loss is then a valid
but weaker perceptual metric, the same fallback the JAX package documents.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn as nn

# (out_channels, pool_before) per conv, grouped by returned slice.
_SLICES = [
    [(64, False)],
    [(64, False), (128, True)],
    [(128, False), (256, True)],
    [(256, False), (256, False), (256, False), (512, True)],
    [(512, False), (512, False), (512, False), (512, True)],
]
# torchvision vgg19 `features` index of each conv (a copy of
# extdm_tpu/convert/torch2jax.py _VGG19_CONV_IDX).
VGG19_CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28]

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


class Vgg19Features(nn.Module):
    """(B, H, W, 3) in [0, 1] -> [relu1_1, relu2_1, relu3_1, relu4_1, relu5_1],
    each channels-last."""

    def __init__(self):
        super().__init__()
        layers, ends, cin = [], [], 3
        for sl in _SLICES:
            for cout, pool_before in sl:
                if pool_before:
                    layers.append(nn.MaxPool2d(2, 2))
                conv = nn.Conv2d(cin, cout, 3, padding=1)
                nn.init.kaiming_normal_(conv.weight, mode="fan_out", nonlinearity="relu")
                nn.init.zeros_(conv.bias)
                layers += [conv, nn.ReLU()]
                cin = cout
            ends.append(len(layers))
        self.features = nn.Sequential(*layers)
        self.ends = ends
        assert [i for i, m in enumerate(layers) if isinstance(m, nn.Conv2d)] == VGG19_CONV_IDX
        self.register_buffer("mean", torch.tensor(_IMAGENET_MEAN).reshape(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(_IMAGENET_STD).reshape(1, 3, 1, 1),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = (x.permute(0, 3, 1, 2).to(self.mean.dtype) - self.mean) / self.std
        outs, start = [], 0
        for end in self.ends:
            x = self.features[start:end](x)
            outs.append(x.permute(0, 2, 3, 1))
            start = end
        return outs
