"""Domain-adaptive Faster R-CNN (counterpart of the JAX package's
`models/detectors/da_faster_rcnn.py:DAFasterRCNN`).

Training (`loss`, reached through `forward(batch, train=True)`):
supervised RPN and RoI losses masked to source images (`domain == 0`);
image-level global CE per global tap (λ_global); the patch least-squares
loss per pixel tap (λ_patch); and, with `instance_mode='grouped'`, the
grouped fg/bg instance loss over the sampled RoIs' shared-FC features
(λ_local). The loss keys are the JAX ones, `globle_da_loss` included.
The 'split_plain' and 'plain' instance modes come with their variants.

At test time the DA detectors are plain Faster R-CNN: the trunk runs with
`with_da=False` and the alignment heads are never run, as in the JAX
module's `predict`.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
from torch import nn
from torch.profiler import record_function

from ...utils.registry import DETECTORS
from ..backbones.da_resnet import VARIANT_TAPS, DAResNet
from ..backbones.resnet import ResNet
from ..da.heads import InstanceAlignmentHead
from ..da.losses import (global_alignment_loss, grouped_instance_loss,
                         patch_ls_loss)
from .faster_rcnn import FasterRCNN


class DALossWeights(NamedTuple):
    """The λs of the DA loss terms."""
    global_: float = 0.1
    patch: float = 0.1
    local: float = 0.2
    consistency: float = 0.1


@DETECTORS.register_module()
class DAFasterRCNN(FasterRCNN):
    """`variant` picks the trunk's alignment taps (daf | daf_org | maf |
    swda | deep | tri); `instance_mode` the instance-level alignment
    (grouped | split_plain | plain | none)."""

    def __init__(self, variant: str = 'daf', instance_mode: str = 'grouped',
                 group_k: int = 20,
                 loss_weights: DALossWeights = DALossWeights(),
                 quirk_detach: bool = False, **kwargs):
        if variant not in VARIANT_TAPS:
            raise ValueError(f'unknown DA variant {variant!r}')
        if instance_mode not in ('grouped', 'split_plain', 'plain', 'none'):
            raise ValueError(f'unknown instance_mode {instance_mode!r}')
        self.variant = variant
        super().__init__(**kwargs)
        self.instance_mode = instance_mode
        self.group_k = group_k
        self.loss_weights = loss_weights
        self.quirk_detach = quirk_detach
        if instance_mode in ('grouped', 'split_plain'):
            self.local_da_fore = InstanceAlignmentHead()
            self.local_da_back = InstanceAlignmentHead()
        elif instance_mode == 'plain':
            self.local_da = InstanceAlignmentHead(use_nonlocal=False)

    def _build_backbone(self, depth: int, frozen_stages: int) -> nn.Module:
        return DAResNet(depth=depth, frozen_stages=frozen_stages,
                        taps=VARIANT_TAPS[self.variant])

    def _trunk(self) -> ResNet:
        return self.backbone.trunk

    def extract_feat(self, image: torch.Tensor) -> torch.Tensor:
        (feat,), _ = self.backbone(image.permute(0, 3, 1, 2), with_da=False)
        return feat

    def loss(self, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             sampler_priorities: Optional[Dict[str, torch.Tensor]] = None
             ) -> Dict[str, torch.Tensor]:
        if self.instance_mode in ('split_plain', 'plain'):
            raise NotImplementedError(
                f'instance_mode {self.instance_mode!r} is not ported yet; it '
                'comes with the MAF / DAF-original variants')
        domain = batch['domain']
        source_mask = (domain == 0).float()
        with record_function('step/trunk_and_grl_heads'):
            (feat,), da_out = self.backbone(
                batch['image'].float().permute(0, 3, 1, 2), with_da=True)
        losses, sampled, cls, shared_feat = self._det_losses(
            feat, batch, source_mask, generator, sampler_priorities)

        with record_function('step/da_losses'):
            w = self.loss_weights
            global_terms, patch_terms = [], []
            for name, out in da_out.items():
                if name.startswith('global'):
                    global_terms.append(global_alignment_loss(
                        out, domain, self.quirk_detach))
                elif name.startswith('pixel'):
                    patch_terms.append(patch_ls_loss(
                        out, domain, quirk_sigmoid_shift=self.quirk_detach))
            if global_terms:
                losses['globle_da_loss'] = w.global_ * sum(global_terms)
            if patch_terms:
                losses['patch_bottom_loss'] = w.patch * sum(patch_terms)
            if self.instance_mode == 'grouped':
                losses['local_da_loss'] = w.local * grouped_instance_loss(
                    self.local_da_fore, self.local_da_back, shared_feat, cls,
                    sampled.label_valid, domain, k=self.group_k,
                    quirk_detach=self.quirk_detach)
        return losses
