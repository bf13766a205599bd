"""Domain-adaptive Faster R-CNN (counterpart of the JAX package's
`models/detectors/da_faster_rcnn.py:DAFasterRCNN`), inference path.

At test time the DA detectors are plain Faster R-CNN: the trunk runs with
`with_da=False` and the alignment heads are never built into the graph, as
in the JAX module's `predict`. Training (GRL heads, DA losses, k-means,
samplers) comes with the training slice.
"""

from __future__ import annotations

import torch
from torch import nn

from ...utils.registry import DETECTORS
from ..backbones.da_resnet import VARIANT_TAPS, DAResNet
from ..backbones.resnet import ResNet
from .faster_rcnn import FasterRCNN


@DETECTORS.register_module()
class DAFasterRCNN(FasterRCNN):
    """`variant` picks the trunk's alignment taps (daf | daf_org | maf |
    swda | deep | tri); it does not change inference."""

    def __init__(self, variant: str = 'daf', **kwargs):
        if variant not in VARIANT_TAPS:
            raise ValueError(f'unknown DA variant {variant!r}')
        self.variant = variant
        super().__init__(**kwargs)

    def _build_backbone(self, depth: int, frozen_stages: int) -> nn.Module:
        return DAResNet(depth=depth, frozen_stages=frozen_stages,
                        taps=VARIANT_TAPS[self.variant])

    def _trunk(self) -> ResNet:
        return self.backbone.trunk

    def extract_feat(self, image: torch.Tensor) -> torch.Tensor:
        (feat,), _ = self.backbone(image.permute(0, 3, 1, 2), with_da=False)
        return feat
