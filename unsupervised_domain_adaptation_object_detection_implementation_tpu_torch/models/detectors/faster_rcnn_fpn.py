"""Faster R-CNN R50-FPN (counterpart of the JAX package's
`models/detectors/faster_rcnn_fpn.py`): losses and inference.

ResNet (stride 32, four stages) → FPN (P2–P6) → an RPN shared over the
levels (3 anchors per location) → proposals → multi-level RoIAlign over
P2–P5 → Shared2FC (softmax classifier) → multiclass NMS. The levels' RPN
outputs and anchors are flattened into single tensors — each level NHWC,
location-major and anchor-minor, the levels in order — so the single-level
RPN loss and proposals apply unchanged, as in the JAX package (a global
top-`nms_pre` over all levels, not mmdet's per-level top-k).

The batch contract, the samplers and `dtype` (the trunk, neck, RPN and
box head's compute type) are those of `faster_rcnn.py`.
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
                                           extract_roi_feats_groie,
                                           roi_head_predict, sample_rois)
from .faster_rcnn import cached_grid_anchors

ROI_STRIDES = (4, 8, 16, 32)


def check_roi_extractor(roi_extractor_type: str) -> None:
    """Raise unless the extractor is one the port has: 'single' (each RoI
    from its level) or 'groie' (every level, summed)."""
    if roi_extractor_type not in ('single', 'groie'):
        raise NotImplementedError(
            f'roi_extractor_type {roi_extractor_type!r}: the port has the '
            "single-level-per-RoI extractor ('single') and GRoIE ('groie')")


class FPNRPNHead(RPNHead):
    """The RPN's 3x3 conv and sibling 1x1 convs, shared by the levels
    (`rpn_conv`, `rpn_cls`, `rpn_reg`, as in the JAX tree)."""

    def __init__(self, in_channels: int = 256, feat_channels: int = 256,
                 num_anchors: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, feat_channels, num_anchors, dtype)

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
        """feats: (B, C, H_l, W_l) levels → per level cls (B, H_l, W_l, A)
        and reg (B, H_l, W_l, A*4)."""
        cls, reg = zip(*(RPNHead.forward(self, f) for f in feats))
        return cls, reg


class FPNProposer(nn.Module):
    """Trunk → FPN → RPN over P2–P6 → proposals: what the FPN two-stage
    detectors share (`FasterRCNNFPN` and its subclasses, the cascade
    family), with their serving surface (`extract_feat`, `rpn_outputs`,
    `roi_maps`, `roi_extract`). Only the plain FPN neck and the default
    ResNet (or Swin) trunk are ported; the other choices raise."""

    roi_extractor_type = 'single'

    def __init__(self, num_classes: int = 80, backbone_depth: int = 50,
                 backbone_cfg: Any = None, neck_type: str = 'FPN',
                 frozen_stages: int = 1,
                 rpn_strides: Tuple[int, ...] = (4, 8, 16, 32, 64),
                 rpn_train_cfg: RPNTrainConfig = RPNTrainConfig(),
                 rpn_proposal_cfg: ProposalConfig = ProposalConfig(
                     nms_pre=4096, max_per_img=1000),
                 rpn_test_cfg: ProposalConfig = ProposalConfig(
                     nms_pre=4096, max_per_img=1000),
                 neck_channels: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_classes = num_classes
        self.rpn_strides = tuple(rpn_strides)
        self.rpn_train_cfg = rpn_train_cfg
        self.rpn_proposal_cfg = rpn_proposal_cfg
        self.rpn_test_cfg = rpn_test_cfg
        self.backbone = build_trunk(
            backbone_cfg, depth=backbone_depth, strides=(1, 2, 2, 2),
            dilations=(1, 1, 1, 1), out_indices=(0, 1, 2, 3),
            frozen_stages=frozen_stages, dtype=dtype)
        self.neck = make_fpn_neck(
            neck_type, in_channels=self.backbone.stage_channels(),
            out_channels=neck_channels, num_outs=5, dtype=dtype)
        self.rpn_head = FPNRPNHead(in_channels=neck_channels, dtype=dtype)

    def extract_feat(self, image: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """image (B, H, W, 3) → the pyramid's (B, C, H_l, W_l) levels P2–P6
        at `dtype`; the NHWC batch enters as a channels_last NCHW view."""
        return self.neck(self.backbone(
            image.to(self.dtype).permute(0, 3, 1, 2)))

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

    def roi_extract(self, feats_nhwc: Sequence[torch.Tensor],
                    rois: torch.Tensor, out_size: int = 7,
                    flatten: bool = True) -> torch.Tensor:
        """The RoI extractor over P2–P5: 7x7 flat x-major for the Shared2FC
        head by default; (B, R, o, o, C) with `flatten=False` (the mask
        branch's 14x14). Each RoI is pooled from its own level, or, with
        `roi_extractor_type='groie'`, from every level, summed."""
        if self.roi_extractor_type == 'groie':
            return extract_roi_feats_groie(feats_nhwc, rois, ROI_STRIDES,
                                           out_size=out_size, flatten=flatten)
        return extract_roi_feats_fpn(feats_nhwc, rois, ROI_STRIDES,
                                     out_size=out_size, flatten=flatten)

    def _proposals(self, batch, generator, sampler_priorities):
        """The trunk, the RPN loss and the proposals from the detached RPN
        outputs, each a `step/...` range → (feats, losses, proposals,
        prop_valid)."""
        pri = sampler_priorities or {}
        with record_function('step/trunk_and_neck'):
            feats = self.extract_feat(batch['image'].float())
        with record_function('step/rpn_head_and_loss'):
            cls, reg, anchors = self.rpn_outputs(feats)
            losses = rpn_loss(cls, reg, anchors, batch['gt_bboxes'],
                              batch['gt_valid'], batch['img_shape'],
                              self.rpn_train_cfg, priorities=pri.get('rpn'),
                              generator=generator)
        with torch.no_grad(), record_function('step/proposals'):
            proposals, _, prop_valid = rpn_proposals(
                cls.detach(), reg.detach(), anchors, batch['img_shape'],
                self.rpn_proposal_cfg)
        return feats, losses, proposals, prop_valid

    def _test_proposals(self, batch):
        """Serving: the pyramid and the proposals of `rpn_test_cfg`."""
        feats = self.extract_feat(batch['image'].float())
        cls, reg, anchors = self.rpn_outputs(feats)
        proposals, _, prop_valid = rpn_proposals(
            cls, reg, anchors, batch['img_shape'], self.rpn_test_cfg)
        return feats, proposals, prop_valid

    def forward(self, batch: Dict[str, torch.Tensor], train: bool = True,
                generator: Optional[torch.Generator] = None,
                sampler_priorities: Optional[Dict[str, torch.Tensor]] = None):
        """The loss dict with `train`, else `predict`."""
        if train:
            return self.loss(batch, generator, sampler_priorities)
        return self.predict(batch)


@DETECTORS.register_module()
class FasterRCNNFPN(FPNProposer):
    """Trunk → FPN → RPN over P2–P6 → proposals → multi-level RoIAlign →
    Shared2FC → multiclass NMS. Only the plain FPN neck, the default ResNet
    trunk, RoIAlign with the single-level-per-RoI extractor or GRoIE's
    all-level sum (`roi_extractor_type='groie'`) and the random sampler are
    ported; the other choices raise. Subclasses swap the box head
    (`bbox_head_type`) and build on the loss's two halves (`_sample`,
    `_box_losses`) and on `_detect`."""

    with_mask = False
    bbox_head_type = Shared2FCBBoxHead

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
                 neck_channels: int = 256,
                 dtype: torch.dtype = torch.float32):
        if roi_layer != 'align':
            raise NotImplementedError(f'roi_layer {roi_layer!r}: only '
                                      "RoIAlign ('align') is ported")
        check_roi_extractor(roi_extractor_type)
        if roi_train_cfg.sampler_type != 'random':
            raise NotImplementedError(
                f'sampler {roi_train_cfg.sampler_type!r}: only the random '
                'sampler is ported')
        super().__init__(num_classes, backbone_depth, backbone_cfg,
                         neck_type, frozen_stages, rpn_strides,
                         rpn_train_cfg, rpn_proposal_cfg, rpn_test_cfg,
                         neck_channels, dtype)
        self.roi_extractor_type = roi_extractor_type
        self.roi_train_cfg = roi_train_cfg
        self.roi_test_cfg = roi_test_cfg
        self.bbox_head = self.bbox_head_type(num_classes=num_classes,
                                             in_channels=neck_channels,
                                             dtype=dtype)

    def loss(self, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             sampler_priorities: Optional[Dict[str, torch.Tensor]] = None
             ) -> Dict[str, torch.Tensor]:
        """RPN and RoI losses. Proposals come from the detached RPN outputs.
        Each stage is a `step/...` profiler range."""
        return self._det_losses(batch, generator, sampler_priorities)[0]

    def _det_losses(self, batch, generator, sampler_priorities):
        """`loss`'s RPN and box losses; returns (losses, sampled RoIs, the
        RoI extractor's NHWC levels)."""
        maps, losses, sampled, _ = self._sample(batch, generator,
                                                sampler_priorities)
        losses.update(self._box_losses(maps, sampled))
        return losses, sampled, maps

    def _sample(self, batch, generator, sampler_priorities):
        """The trunk, the RPN loss, the proposals and the RoI sampler →
        (the RoI extractor's NHWC levels, the RPN losses, the sampled RoIs,
        the proposals)."""
        pri = sampler_priorities or {}
        feats, losses, proposals, prop_valid = self._proposals(
            batch, generator, sampler_priorities)
        with torch.no_grad(), record_function('step/roi_sampling'):
            sampled = sample_rois(
                proposals, prop_valid, batch['gt_bboxes'],
                batch['gt_labels'], batch['gt_valid'], self.num_classes,
                self.roi_train_cfg, priorities=pri.get('rcnn'),
                generator=generator)
        return self.roi_maps(feats), losses, sampled, proposals

    def _box_losses(self, maps, sampled) -> Dict[str, torch.Tensor]:
        """The box head's losses on the sampled RoIs."""
        with record_function('step/roi_align_fwd'):
            roi_feats = self.roi_extract(maps, sampled.rois)
        with record_function('step/bbox_head_and_loss'):
            cls_s, reg_s, _ = self.bbox_head(roi_feats)
            return bbox_loss(cls_s, reg_s, sampled, self.num_classes,
                             self.roi_train_cfg)

    @torch.inference_mode()
    def predict(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """simple_test flow: RPN proposals over all levels → multi-level
        RoI head → per-class NMS."""
        return self._detect(batch)[0]

    def _detect(self, batch, with_reg: bool = True, roi_extractor=None):
        """`predict`'s detections and the RoI extractor's NHWC levels;
        `with_reg=False` scores the proposals themselves, `roi_extractor`
        replaces `roi_extract`."""
        feats, proposals, prop_valid = self._test_proposals(batch)
        maps = self.roi_maps(feats)
        return roi_head_predict(
            self.bbox_head, maps, proposals,
            prop_valid, batch['img_shape'], self.num_classes,
            reg_class_agnostic=False,
            target_stds=self.roi_train_cfg.target_stds,
            use_sigmoid_cls=self.roi_train_cfg.use_sigmoid_cls,
            cfg=self.roi_test_cfg,
            roi_extractor=roi_extractor or self.roi_extract,
            with_reg=with_reg), maps
