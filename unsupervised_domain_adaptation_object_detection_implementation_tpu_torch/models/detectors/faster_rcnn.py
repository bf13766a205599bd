"""Faster R-CNN on the single-level DC5 trunk (counterpart of the JAX
package's `models/detectors/faster_rcnn.py`): losses and inference.

Batch contract (from `data.pipelines.PackDetInputs` + `data.collate`):
    image (B, H, W, 3) float32 · img_shape (B, 2) (h, w) int
    and, to train: gt_bboxes (B, G, 4) · gt_labels (B, G) · gt_valid (B, G)
    · domain (B,)
Inference outputs: dets (B, max, 5), labels (B, max), valid (B, max).

`dtype` is the compute type of the trunk, the RPN and the box head (the
image is cast to it before the trunk); losses, proposals and the box
decode run in f32, as in the JAX package.

The samplers draw their priorities from the `generator` the caller passes,
or take them from `sampler_priorities` = dict(rpn=(B, N anchors),
rcnn=(B, G + P candidates)), as the parity tests do.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from ...core.anchors.anchor_generator import AnchorGenerator
from ...utils.registry import DETECTORS
from ..backbones.resnet import ResNet
from ..dense_heads.rpn_head import (ProposalConfig, RPNHead, RPNTrainConfig,
                                    rpn_loss, rpn_proposals)
from ..roi_heads.bbox_head import Shared2FCBBoxHead
from ..roi_heads.standard_roi_head import (RoITestConfig, RoITrainConfig,
                                           bbox_loss, extract_roi_feats,
                                           roi_head_predict, sample_rois)


class AnchorConfig(NamedTuple):
    """Anchor scales/ratios/stride of the DA configs' RPN."""
    scales: Tuple[float, ...] = (2, 4, 8, 16, 32)
    ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    stride: int = 16

    @property
    def num_anchors(self) -> int:
        return len(self.scales) * len(self.ratios)

    def grid_anchors(self, feat_h: int, feat_w: int) -> np.ndarray:
        return cached_grid_anchors((self.stride,), self.ratios, self.scales,
                                   ((feat_h, feat_w),))


@functools.lru_cache(maxsize=16)
def cached_grid_anchors(strides: Tuple[int, ...], ratios: Tuple[float, ...],
                        scales: Tuple[float, ...],
                        sizes: Tuple[Tuple[int, int], ...]) -> np.ndarray:
    """The anchors of each level's (h, w) grid, (h, w, anchor)-major, the
    levels concatenated in order; read-only, cached per geometry."""
    gen = AnchorGenerator(strides=list(strides), ratios=list(ratios),
                          scales=list(scales))
    anchors = np.concatenate(gen.grid_priors(list(sizes)), axis=0)
    anchors.setflags(write=False)
    return anchors


@DETECTORS.register_module()
class FasterRCNN(nn.Module):
    """Trunk → RPN → proposals → RoIAlign → Shared2FC → multiclass NMS."""

    def __init__(self, num_classes: int = 8, backbone_depth: int = 50,
                 frozen_stages: int = 1,
                 anchor_cfg: AnchorConfig = AnchorConfig(),
                 rpn_train_cfg: RPNTrainConfig = RPNTrainConfig(),
                 rpn_proposal_cfg: ProposalConfig = ProposalConfig(),
                 rpn_test_cfg: ProposalConfig = ProposalConfig(
                     nms_pre=4096, max_per_img=1000),
                 roi_train_cfg: RoITrainConfig = RoITrainConfig(),
                 roi_test_cfg: RoITestConfig = RoITestConfig(),
                 featmap_stride: int = 16,
                 rpn_feat_channels: int = 2048,
                 fc_out_channels: int = 1024,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_classes = num_classes
        self.anchor_cfg = anchor_cfg
        self.rpn_train_cfg = rpn_train_cfg
        self.rpn_proposal_cfg = rpn_proposal_cfg
        self.rpn_test_cfg = rpn_test_cfg
        self.roi_train_cfg = roi_train_cfg
        self.roi_test_cfg = roi_test_cfg
        self.featmap_stride = featmap_stride
        self.backbone = self._build_backbone(backbone_depth, frozen_stages)
        # the tapped stage's width (C5 on the DC5 trunk, stage 2 on Swin)
        width = self._trunk().stage_channels()[self.backbone.out_indices[0]]
        self.rpn_head = RPNHead(in_channels=width,
                                feat_channels=rpn_feat_channels,
                                num_anchors=anchor_cfg.num_anchors,
                                dtype=dtype)
        self.bbox_head = Shared2FCBBoxHead(num_classes=num_classes,
                                           in_channels=width,
                                           fc_out_channels=fc_out_channels,
                                           dtype=dtype)

    def _build_backbone(self, depth: int, frozen_stages: int) -> nn.Module:
        return ResNet(depth=depth, strides=(1, 2, 2, 1),
                      dilations=(1, 1, 1, 2), out_indices=(3,),
                      frozen_stages=frozen_stages, dtype=self.dtype)

    def _trunk(self) -> nn.Module:
        return self.backbone

    def extract_feat(self, image: torch.Tensor) -> torch.Tensor:
        """image (B, H, W, 3) → stride-16 features (B, C, H/16, W/16) at
        `dtype`; the NHWC batch enters as a channels_last NCHW view."""
        (feat,) = self.backbone(image.to(self.dtype).permute(0, 3, 1, 2))
        return feat

    # The serving surface that FasterRCNNFPN shares: RPN outputs and
    # anchors, the RoI extractor's input and the RoI extractor.
    def rpn_outputs(self, feat: torch.Tensor):
        """RPN → cls (B, H, W, A), reg (B, H, W, A*4) and the anchors
        (H*W*A, 4), as `rpn_loss` and `rpn_proposals` take them."""
        h, w = feat.shape[-2], feat.shape[-1]
        anchors = torch.tensor(self.anchor_cfg.grid_anchors(h, w),
                               device=feat.device)
        return (*self.rpn_head(feat), anchors)

    @staticmethod
    def roi_maps(feat: torch.Tensor) -> torch.Tensor:
        """The RoI extractor's input (B, H, W, C); a no-op view of the
        channels_last map on the card."""
        return feat.permute(0, 2, 3, 1).contiguous()

    def roi_extract(self, feats_nhwc: torch.Tensor, rois: torch.Tensor
                    ) -> torch.Tensor:
        """RoIAlign at the feature stride, 7x7, flat x-major for the
        Shared2FC head."""
        return extract_roi_feats(feats_nhwc, rois, self.featmap_stride,
                                 flatten=True)

    def loss(self, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             sampler_priorities: Optional[Dict[str, torch.Tensor]] = None
             ) -> Dict[str, torch.Tensor]:
        with record_function('step/trunk'):
            feat = self.extract_feat(batch['image'].float())
        return self._det_losses(feat, batch, None, generator,
                                sampler_priorities)[0]

    def _det_losses(self, feat, batch, loss_weight_mask, generator,
                    sampler_priorities):
        """Supervised RPN + RoI losses; returns (losses, sampled RoIs, class
        scores, shared-FC features). Proposals come from the detached RPN
        outputs. Each stage is a `step/...` profiler range."""
        pri = sampler_priorities or {}
        with record_function('step/rpn_head_and_loss'):
            rpn_cls, rpn_reg, anchors = self.rpn_outputs(feat)
            losses = rpn_loss(rpn_cls, rpn_reg, anchors, batch['gt_bboxes'],
                              batch['gt_valid'], batch['img_shape'],
                              self.rpn_train_cfg, loss_weight_mask,
                              priorities=pri.get('rpn'), generator=generator)
        with torch.no_grad():
            with record_function('step/proposals'):
                proposals, _, prop_valid = rpn_proposals(
                    rpn_cls.detach(), rpn_reg.detach(), anchors,
                    batch['img_shape'], self.rpn_proposal_cfg)
            with record_function('step/roi_sampling'):
                sampled = sample_rois(
                    proposals, prop_valid, batch['gt_bboxes'],
                    batch['gt_labels'], batch['gt_valid'], self.num_classes,
                    self.roi_train_cfg, priorities=pri.get('rcnn'),
                    generator=generator)
        with record_function('step/roi_align_fwd'):
            roi_feats = self.roi_extract(self.roi_maps(feat), sampled.rois)
        with record_function('step/bbox_head_and_loss'):
            cls, reg, shared_feat = self.bbox_head(roi_feats)
            losses.update(bbox_loss(cls, reg, sampled, self.num_classes,
                                    self.roi_train_cfg, loss_weight_mask))
        return losses, sampled, cls, shared_feat

    @torch.inference_mode()
    def predict(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """simple_test flow: RPN proposals → RoI head → per-class NMS."""
        feat = self.extract_feat(batch['image'].float())
        rpn_cls, rpn_reg, anchors = self.rpn_outputs(feat)
        proposals, _, prop_valid = rpn_proposals(
            rpn_cls, rpn_reg, anchors, batch['img_shape'], self.rpn_test_cfg)
        return roi_head_predict(
            self.bbox_head, self.roi_maps(feat), proposals,
            prop_valid, batch['img_shape'], self.num_classes,
            self.featmap_stride, reg_class_agnostic=False,
            target_stds=self.roi_train_cfg.target_stds,
            use_sigmoid_cls=self.roi_train_cfg.use_sigmoid_cls,
            cfg=self.roi_test_cfg)

    def forward(self, batch: Dict[str, torch.Tensor], train: bool = True,
                generator: Optional[torch.Generator] = None,
                sampler_priorities: Optional[Dict[str, torch.Tensor]] = None):
        """The loss dict with `train`, else `predict`."""
        if train:
            return self.loss(batch, generator, sampler_priorities)
        return self.predict(batch)
