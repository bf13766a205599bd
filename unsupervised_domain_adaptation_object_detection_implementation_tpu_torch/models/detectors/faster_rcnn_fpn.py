"""Faster R-CNN R50-FPN (counterpart of the JAX package's
`models/detectors/faster_rcnn_fpn.py`): losses and inference.

ResNet (stride 32, four stages) → FPN (P2–P6) → an RPN shared over the
levels (3 anchors per location) → proposals → multi-level RoIAlign over
P2–P5 → Shared2FC (softmax classifier) → multiclass NMS. The levels' RPN
outputs and anchors are flattened into single tensors — each level NHWC,
location-major and anchor-minor, the levels in order — so the single-level
RPN loss and proposals apply unchanged, as in the JAX package (a global
top-`nms_pre` over all levels, not mmdet's per-level top-k).

The batch contract and the samplers are those of `faster_rcnn.py`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from ...utils.registry import DETECTORS
from ..backbones.build import build_trunk
from ..dense_heads.anchor_head import flatten_level_preds
from ..dense_heads.rpn_head import (ProposalConfig, RPNHead, RPNTrainConfig,
                                    rpn_loss, rpn_proposals)
from ..necks.build import make_fpn_neck
from ..roi_heads.bbox_head import Shared2FCBBoxHead
from ..roi_heads.standard_roi_head import (RoITestConfig, RoITrainConfig,
                                           bbox_loss, extract_roi_feats_fpn,
                                           roi_head_predict, sample_rois)
from .faster_rcnn import cached_grid_anchors

ROI_STRIDES = (4, 8, 16, 32)


class FPNRPNHead(RPNHead):
    """The RPN's 3x3 conv and sibling 1x1 convs, shared by the levels
    (`rpn_conv`, `rpn_cls`, `rpn_reg`, as in the JAX tree)."""

    def __init__(self, in_channels: int = 256, feat_channels: int = 256,
                 num_anchors: int = 3):
        super().__init__(in_channels, feat_channels, num_anchors)

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
        """feats: (B, C, H_l, W_l) levels → per level cls (B, H_l, W_l, A)
        and reg (B, H_l, W_l, A*4)."""
        cls, reg = zip(*(RPNHead.forward(self, f) for f in feats))
        return cls, reg


@DETECTORS.register_module()
class FasterRCNNFPN(nn.Module):
    """Trunk → FPN → RPN over P2–P6 → proposals → multi-level RoIAlign →
    Shared2FC → multiclass NMS. Only the plain FPN neck, the default ResNet
    trunk, RoIAlign with the single-level-per-RoI extractor and the random
    sampler are ported; the other choices raise."""

    def __init__(self, num_classes: int = 80, backbone_depth: int = 50,
                 backbone_cfg: Any = None, neck_type: str = 'FPN',
                 roi_extractor_type: str = 'single', roi_layer: str = 'align',
                 frozen_stages: int = 1,
                 rpn_strides: Tuple[int, ...] = (4, 8, 16, 32, 64),
                 rpn_train_cfg: RPNTrainConfig = RPNTrainConfig(),
                 rpn_proposal_cfg: ProposalConfig = ProposalConfig(
                     nms_pre=4096, max_per_img=1000),
                 rpn_test_cfg: ProposalConfig = ProposalConfig(
                     nms_pre=4096, max_per_img=1000),
                 roi_train_cfg: RoITrainConfig = RoITrainConfig(
                     use_sigmoid_cls=False),
                 roi_test_cfg: RoITestConfig = RoITestConfig(),
                 neck_channels: int = 256):
        super().__init__()
        if roi_layer != 'align':
            raise NotImplementedError(f'roi_layer {roi_layer!r}: only '
                                      "RoIAlign ('align') is ported")
        if roi_extractor_type != 'single':
            raise NotImplementedError(
                f'roi_extractor_type {roi_extractor_type!r}: only the '
                "single-level-per-RoI extractor ('single') is ported")
        if roi_train_cfg.sampler_type != 'random':
            raise NotImplementedError(
                f'sampler {roi_train_cfg.sampler_type!r}: only the random '
                'sampler is ported')
        self.num_classes = num_classes
        self.rpn_strides = tuple(rpn_strides)
        self.rpn_train_cfg = rpn_train_cfg
        self.rpn_proposal_cfg = rpn_proposal_cfg
        self.rpn_test_cfg = rpn_test_cfg
        self.roi_train_cfg = roi_train_cfg
        self.roi_test_cfg = roi_test_cfg
        self.backbone = build_trunk(
            backbone_cfg, depth=backbone_depth, strides=(1, 2, 2, 2),
            dilations=(1, 1, 1, 1), out_indices=(0, 1, 2, 3),
            frozen_stages=frozen_stages)
        self.neck = make_fpn_neck(
            neck_type, in_channels=self.backbone.stage_channels(),
            out_channels=neck_channels, num_outs=5)
        self.rpn_head = FPNRPNHead(in_channels=neck_channels)
        self.bbox_head = Shared2FCBBoxHead(num_classes=num_classes,
                                           in_channels=neck_channels)

    def extract_feat(self, image: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """image (B, H, W, 3) → the pyramid's (B, C, H_l, W_l) levels P2–P6;
        the NHWC batch enters as a channels_last NCHW view."""
        return self.neck(self.backbone(image.permute(0, 3, 1, 2)))

    # The serving surface of `FasterRCNN`, over the levels.
    def rpn_outputs(self, feats: Sequence[torch.Tensor]):
        """RPN over every level, flattened → cls (B, N, 1, 1), reg (B, N, 1,
        4) and the anchors (N, 4), N summed over the levels: the
        single-level shapes that `rpn_loss` and `rpn_proposals` take."""
        cls_levels, reg_levels = self.rpn_head(feats)
        sizes = tuple((f.shape[-2], f.shape[-1]) for f in feats)
        anchors = torch.tensor(
            cached_grid_anchors(self.rpn_strides, (0.5, 1.0, 2.0), (8,),
                                sizes), device=feats[0].device)
        cls = flatten_level_preds(cls_levels, 1)
        reg = flatten_level_preds(reg_levels, 4)
        b, n = cls.shape[:2]
        return cls.reshape(b, n, 1, 1), reg.reshape(b, n, 1, 4), anchors

    @staticmethod
    def roi_maps(feats: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """The RoI extractor's levels P2–P5 as (B, H_l, W_l, C); a no-op
        view of the channels_last maps on the card."""
        return tuple(f.permute(0, 2, 3, 1).contiguous()
                     for f in feats[:len(ROI_STRIDES)])

    @staticmethod
    def roi_extract(feats_nhwc: Sequence[torch.Tensor], rois: torch.Tensor
                    ) -> torch.Tensor:
        """Multi-level RoIAlign, 7x7, flat x-major for the Shared2FC head."""
        return extract_roi_feats_fpn(feats_nhwc, rois, ROI_STRIDES,
                                     flatten=True)

    def loss(self, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             sampler_priorities: Optional[Dict[str, torch.Tensor]] = None
             ) -> Dict[str, torch.Tensor]:
        """RPN and RoI losses. Proposals come from the detached RPN outputs.
        Each stage is a `step/...` profiler range."""
        pri = sampler_priorities or {}
        with record_function('step/trunk_and_neck'):
            feats = self.extract_feat(batch['image'].float())
        with record_function('step/rpn_head_and_loss'):
            cls, reg, anchors = self.rpn_outputs(feats)
            losses = rpn_loss(cls, reg, anchors, batch['gt_bboxes'],
                              batch['gt_valid'], batch['img_shape'],
                              self.rpn_train_cfg, priorities=pri.get('rpn'),
                              generator=generator)
        with torch.no_grad():
            with record_function('step/proposals'):
                proposals, _, prop_valid = rpn_proposals(
                    cls.detach(), reg.detach(), anchors, batch['img_shape'],
                    self.rpn_proposal_cfg)
            with record_function('step/roi_sampling'):
                sampled = sample_rois(
                    proposals, prop_valid, batch['gt_bboxes'],
                    batch['gt_labels'], batch['gt_valid'], self.num_classes,
                    self.roi_train_cfg, priorities=pri.get('rcnn'),
                    generator=generator)
        with record_function('step/roi_align_fwd'):
            roi_feats = self.roi_extract(self.roi_maps(feats), sampled.rois)
        with record_function('step/bbox_head_and_loss'):
            cls_s, reg_s, _ = self.bbox_head(roi_feats)
            losses.update(bbox_loss(cls_s, reg_s, sampled, self.num_classes,
                                    self.roi_train_cfg))
        return losses

    @torch.inference_mode()
    def predict(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """simple_test flow: RPN proposals over all levels → multi-level
        RoI head → per-class NMS."""
        feats = self.extract_feat(batch['image'].float())
        cls, reg, anchors = self.rpn_outputs(feats)
        proposals, _, prop_valid = rpn_proposals(
            cls, reg, anchors, batch['img_shape'], self.rpn_test_cfg)
        return roi_head_predict(
            self.bbox_head, self.roi_maps(feats), proposals,
            prop_valid, batch['img_shape'], self.num_classes,
            reg_class_agnostic=False,
            target_stds=self.roi_train_cfg.target_stds,
            use_sigmoid_cls=self.roi_train_cfg.use_sigmoid_cls,
            cfg=self.roi_test_cfg, roi_extractor=self.roi_extract)

    def forward(self, batch: Dict[str, torch.Tensor], train: bool = True,
                generator: Optional[torch.Generator] = None,
                sampler_priorities: Optional[Dict[str, torch.Tensor]] = None):
        """The loss dict with `train`, else `predict`."""
        if train:
            return self.loss(batch, generator, sampler_priorities)
        return self.predict(batch)
