"""Domain-adaptive Faster R-CNN (counterpart of the JAX package's
`models/detectors/da_faster_rcnn.py:DAFasterRCNN`).

Training (`loss`, reached through `forward(batch, train=True)`):
supervised RPN and RoI losses masked to source images (`domain == 0`);
image-level global CE per global and SRM tap (λ_global, `globle_da_loss`);
the patch least-squares loss per pixel tap (λ_patch, `patch_bottom_loss`);
the least-squares image loss per image tap (λ_global, `img_da_loss`); and
the instance loss over the sampled RoIs' shared-FC features (λ_local,
`local_da_loss`): grouped fg/bg with k-means representatives
('grouped'), fg/bg CE without grouping ('split_plain', MAF) or one CE over
every RoI ('plain', DAF-original, with the consistency loss `consist_loss`
(λ_consistency) against the first image map). The loss keys are the JAX
ones, letter for letter.

The MHSA taps of the 'tri' variant are built for `canvas`, the static
training canvas (see `backbones/da_resnet.py`).

On a bf16 detector (`dtype`) the alignment heads run in f32 on the
upcast taps and shared-FC features, as the JAX package's heads, which
get no `dtype`, do; the fg/bg split's softmax runs in the box logits'
type, as there.

At test time the DA detectors are plain Faster R-CNN: the trunk runs with
`with_da=False` and the alignment heads are never run, as in the JAX
module's `predict`.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from ...parallel.batch import (batch_total, data_parallel, gather_rows,
                               replica_share, replicated)
from ...utils.registry import DETECTORS
from ..backbones.da_resnet import VARIANT_TAPS, DAResNet
from ..da.heads import InstanceAlignmentHead
from ..da.losses import (consistency_loss, global_alignment_loss,
                         grouped_instance_loss, image_da_loss, patch_ls_loss)
from ..losses import softmax_cross_entropy
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
                 quirk_detach: bool = False,
                 backbone_type: str = 'resnet',
                 canvas: Tuple[int, int] = (512, 1024), **kwargs):
        if variant not in VARIANT_TAPS:
            raise ValueError(f'unknown DA variant {variant!r}')
        if instance_mode not in ('grouped', 'split_plain', 'plain', 'none'):
            raise ValueError(f'unknown instance_mode {instance_mode!r}')
        self.variant = variant
        self.backbone_type = backbone_type
        self.canvas = tuple(canvas)
        super().__init__(**kwargs)
        self.instance_mode = instance_mode
        self.group_k = group_k
        self.loss_weights = loss_weights
        self.quirk_detach = quirk_detach
        feat_dim = self.bbox_head.shared_fc2.out_features
        if instance_mode in ('grouped', 'split_plain'):
            self.local_da_fore = InstanceAlignmentHead(feat_dim)
            self.local_da_back = InstanceAlignmentHead(feat_dim)
        elif instance_mode == 'plain':
            self.local_da = InstanceAlignmentHead(feat_dim,
                                                  use_nonlocal=False)

    def _build_backbone(self, depth: int, frozen_stages: int) -> nn.Module:
        # the Swin trunk is tapped at the stage of `featmap_stride` (stage 2
        # at stride 16), the ResNet trunk at its dilated C5
        out_indices = (max(0, self.featmap_stride.bit_length() - 3),) \
            if self.backbone_type == 'swin' else (3,)
        return DAResNet(depth=depth, frozen_stages=frozen_stages,
                        taps=VARIANT_TAPS[self.variant],
                        trunk_type=self.backbone_type,
                        out_indices=out_indices, canvas=self.canvas,
                        dtype=self.dtype)

    def _trunk(self) -> nn.Module:
        return self.backbone.trunk

    def extract_feat(self, image: torch.Tensor) -> torch.Tensor:
        (feat,), _ = self.backbone(image.to(self.dtype).permute(0, 3, 1, 2),
                                   with_da=False)
        return feat

    def loss(self, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             sampler_priorities: Optional[Dict[str, torch.Tensor]] = None
             ) -> Dict[str, torch.Tensor]:
        domain = batch['domain']
        source_mask = (domain == 0).float()
        with record_function('step/trunk_and_grl_heads'):
            (feat,), da_out = self.backbone(
                batch['image'].to(self.dtype).permute(0, 3, 1, 2),
                with_da=True)
        losses, sampled, cls, shared_feat = self._det_losses(
            feat, batch, source_mask, generator, sampler_priorities)

        with record_function('step/da_losses'):
            losses.update(self._da_losses(da_out, domain, sampled, cls,
                                          shared_feat))
        return losses

    def _da_losses(self, da_out, domain, sampled, cls, shared_feat):
        """The alignment terms: per tap kind, then the instance mode's."""
        w = self.loss_weights
        losses = {}
        global_terms, patch_terms, image_maps = [], [], []
        for name, out in da_out.items():
            if name.startswith(('global', 'srm')):
                global_terms.append(global_alignment_loss(
                    out, domain, self.quirk_detach))
            elif name.startswith('pixel'):
                patch_terms.append(patch_ls_loss(
                    out, domain, quirk_sigmoid_shift=self.quirk_detach))
            elif name.startswith('image'):
                image_maps.append(out)
        if global_terms:
            losses['globle_da_loss'] = w.global_ * sum(global_terms)
        if patch_terms:
            losses['patch_bottom_loss'] = w.patch * sum(patch_terms)
        if image_maps:
            losses['img_da_loss'] = w.global_ * sum(
                image_da_loss(m, domain) for m in image_maps)

        valid = sampled.label_valid
        if self.instance_mode == 'grouped':
            losses['local_da_loss'] = w.local * grouped_instance_loss(
                self.local_da_fore, self.local_da_back, shared_feat, cls,
                valid, domain, k=self.group_k,
                quirk_detach=self.quirk_detach)
        elif self.instance_mode == 'split_plain':
            losses['local_da_loss'] = w.local * self._split_plain_loss(
                shared_feat, cls, valid, domain)
        elif self.instance_mode == 'plain':
            b, s = valid.shape
            ins_logits = self.local_da(
                shared_feat.reshape(-1, shared_feat.shape[-1])).reshape(b, s, 2)
            dom_t = domain[:, None].expand(b, s)
            v = valid.float()
            ce = softmax_cross_entropy(ins_logits, dom_t) * v
            losses['local_da_loss'] = w.local * ce.sum() / torch.clamp(
                batch_total(v.sum()), min=1.0)
            if image_maps:
                losses['consist_loss'] = w.consistency * consistency_loss(
                    image_maps[0], ins_logits, valid, domain)
        return losses

    def _split_plain_loss(self, shared_feat, cls, valid, domain):
        """MAF's fg/bg split instance CE without k-means grouping: each RoI
        is foreground when its softmax background probability is at most
        0.5; the fore and back heads see every RoI, and each CE is averaged
        over its own valid RoIs. The heads' non-local blocks attend over
        every RoI of the batch, so under data parallelism every rank runs
        them on the global batch's RoIs and returns its share."""
        if data_parallel():
            args = (gather_rows(shared_feat), gather_rows(cls.detach()),
                    gather_rows(valid), gather_rows(domain))
            with replicated():
                total = self._split_plain_loss(*args)
            return replica_share(total)
        b, s, d = shared_feat.shape
        probs = torch.softmax(cls, dim=-1)
        is_fg = (1.0 - probs[..., -1]) >= 0.5
        dom_t = domain[:, None].expand(b, s).reshape(-1)
        flat = shared_feat.reshape(-1, d)
        total = 0.0
        for fg, head in ((True, self.local_da_fore),
                         (False, self.local_da_back)):
            mask = (valid & (is_fg == fg)).reshape(-1).float()
            ce = softmax_cross_entropy(head(flat), dom_t) * mask
            total = total + ce.sum() / torch.clamp(mask.sum(), min=1.0)
        return total
