"""Mask R-CNN C4 (counterpart of the JAX package's
`models/detectors/mask_rcnn_c4.py`): the shared-res5 RoI trunk.

The trunk stops at C4 (three stages, stride 16). Each RoI's 14x14 RoIAlign
crop of C4 runs through ResNet's stage 4 (res5, stride 2) as a shared head
→ 7x7x2048; the box head is a global average pool and two sibling linears
(`BBoxHead(with_avg_pool=True)`), and the mask head (no convs, 2x upsample
to 14x14) reuses the same res5 output. The crops (B, R, 14, 14, C), which
the RoIAlign kernel writes NHWC, fold into the batch for res5 as a
channels_last (B·R, C, 14, 14) view, with no copy.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from ...utils.registry import DETECTORS
from ..backbones.build import build_trunk
from ..backbones.resnet import ARCH_SETTINGS
from ..dense_heads.rpn_head import (ProposalConfig, RPNHead, RPNTrainConfig,
                                    rpn_loss, rpn_proposals)
from ..layers.precision import Linear
from ..roi_heads.mask_head import (FCNMaskHead, mask_loss,
                                   mask_targets_from_box_frame)
from ..roi_heads.standard_roi_head import (RoITestConfig, RoITrainConfig,
                                           bbox_loss, extract_roi_feats,
                                           roi_head_predict, sample_rois)
from .faster_rcnn import AnchorConfig
from .mask_rcnn import select_class_masks


class ResLayerSharedHead(nn.Module):
    """res5 as a shared RoI head: ResNet stage 4 (first block strided and
    downsampling) on the RoIs folded into the batch. Blocks are named
    `res5_block{i}` as in the JAX tree."""

    def __init__(self, depth: int = 50, in_channels: int = 1024,
                 stride: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        block_cls, stage_blocks = ARCH_SETTINGS[depth]
        self.num_blocks = stage_blocks[3]
        ch = in_channels
        for i in range(self.num_blocks):
            self.add_module(f'res5_block{i}', block_cls(
                ch, 512, stride=stride if i == 0 else 1, downsample=i == 0,
                dtype=dtype))
            ch = 512 * block_cls.expansion
        self.out_channels = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, R, s, s, C) NHWC → (B, R, s/2, s/2, C_out) NHWC, a view of
        the channels_last result."""
        b, r, s, _, c = x.shape
        y = x.reshape(b * r, s, s, c).permute(0, 3, 1, 2)
        for i in range(self.num_blocks):
            y = getattr(self, f'res5_block{i}')(y)
        return y.permute(0, 2, 3, 1).reshape(b, r, *y.shape[2:], -1)


class C4BBoxHead(nn.Module):
    """Global average pool of the res5 output, then sibling `fc_cls` (K+1)
    and `fc_reg` (4K), at `dtype`; returns the pooled feature too."""

    def __init__(self, num_classes: int = 80, in_channels: int = 2048,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc_cls = Linear(in_channels, num_classes + 1,
                             compute_dtype=dtype)
        self.fc_reg = Linear(in_channels, num_classes * 4,
                             compute_dtype=dtype)

    def forward(self, roi_feats: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        feat = roi_feats.mean(dim=(-3, -2))
        return self.fc_cls(feat), self.fc_reg(feat), feat


@DETECTORS.register_module()
class MaskRCNNC4(nn.Module):
    """Trunk to C4 → RPN → proposals → 14x14 RoIAlign → res5 → box head
    (and, `with_mask`, the mask head on the same res5 output) → multiclass
    NMS. `dtype` is the compute type of the trunk, the RPN, res5 and the
    box and mask heads. Only the default ResNet trunk is ported; a
    `backbone_cfg` raises."""

    def __init__(self, num_classes: int = 80, backbone_depth: int = 50,
                 backbone_cfg: Any = None, frozen_stages: int = 1,
                 anchor_cfg: AnchorConfig = AnchorConfig(),
                 rpn_train_cfg: RPNTrainConfig = RPNTrainConfig(),
                 rpn_proposal_cfg: ProposalConfig = ProposalConfig(),
                 rpn_test_cfg: ProposalConfig = ProposalConfig(
                     nms_pre=4096, max_per_img=1000),
                 roi_train_cfg: RoITrainConfig = RoITrainConfig(
                     use_sigmoid_cls=False),
                 roi_test_cfg: RoITestConfig = RoITestConfig(),
                 featmap_stride: int = 16, roi_size: int = 14,
                 mask_size: int = 14, with_mask: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        if backbone_cfg is not None:
            raise NotImplementedError(
                f'MaskRCNNC4 with backbone_cfg {backbone_cfg!r}: only its '
                'default ResNet trunk is ported')
        if roi_train_cfg.sampler_type != 'random':
            raise NotImplementedError(
                f'sampler {roi_train_cfg.sampler_type!r}: only the random '
                'sampler is ported')
        self.num_classes = num_classes
        self.anchor_cfg = anchor_cfg
        self.rpn_train_cfg = rpn_train_cfg
        self.rpn_proposal_cfg = rpn_proposal_cfg
        self.rpn_test_cfg = rpn_test_cfg
        self.roi_train_cfg = roi_train_cfg
        self.roi_test_cfg = roi_test_cfg
        self.featmap_stride = featmap_stride
        self.roi_size = roi_size
        self.mask_size = mask_size
        self.with_mask = with_mask
        self.backbone = build_trunk(
            backbone_cfg, depth=backbone_depth, num_stages=3,
            strides=(1, 2, 2), dilations=(1, 1, 1), out_indices=(2,),
            frozen_stages=frozen_stages, dtype=dtype)
        c4 = self.backbone.stage_channels()[-1]
        self.rpn_head = RPNHead(in_channels=c4, feat_channels=1024,
                                num_anchors=anchor_cfg.num_anchors,
                                dtype=dtype)
        self.shared_head = ResLayerSharedHead(backbone_depth, c4,
                                              dtype=dtype)
        width = self.shared_head.out_channels
        self.bbox_head = C4BBoxHead(num_classes, width, dtype)
        if with_mask:
            self.mask_head = FCNMaskHead(num_classes=num_classes,
                                         num_convs=0, in_channels=width,
                                         dtype=dtype)

    def extract_feat(self, image: torch.Tensor) -> torch.Tensor:
        """image (B, H, W, 3) → C4 (B, C, H/16, W/16) at `dtype`; the NHWC
        batch enters as a channels_last NCHW view."""
        (feat,) = self.backbone(image.to(self.dtype).permute(0, 3, 1, 2))
        return feat

    # The serving surface of `FasterRCNN`; the box head applies res5 first.
    def rpn_outputs(self, feat: torch.Tensor):
        """RPN → cls (B, H, W, A), reg (B, H, W, A*4) and the anchors."""
        h, w = feat.shape[-2], feat.shape[-1]
        anchors = torch.tensor(self.anchor_cfg.grid_anchors(h, w),
                               device=feat.device)
        return (*self.rpn_head(feat), anchors)

    @staticmethod
    def roi_maps(feat: torch.Tensor) -> torch.Tensor:
        """C4 as (B, H, W, C); a no-op view of the channels_last map on the
        card."""
        return feat.permute(0, 2, 3, 1).contiguous()

    def roi_extract(self, feats_nhwc: torch.Tensor, rois: torch.Tensor
                    ) -> torch.Tensor:
        """RoIAlign of C4 at the feature stride → (B, R, 14, 14, C)."""
        return extract_roi_feats(feats_nhwc, rois, self.featmap_stride,
                                 out_size=self.roi_size)

    def roi_box_head(self, crops: torch.Tensor):
        """res5, then the box head: (cls, reg, pooled feature)."""
        return self.bbox_head(self.shared_head(crops))

    def loss(self, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             sampler_priorities: Optional[Dict[str, torch.Tensor]] = None
             ) -> Dict[str, torch.Tensor]:
        """RPN, box and (with `with_mask`) mask losses; the mask branch on
        all sampled RoIs, positives weighted, from the res5 output the box
        head reads. Each stage is a `step/...` profiler range."""
        pri = sampler_priorities or {}
        with record_function('step/trunk'):
            feat = self.extract_feat(batch['image'].float())
        with record_function('step/rpn_head_and_loss'):
            rpn_cls, rpn_reg, anchors = self.rpn_outputs(feat)
            losses = rpn_loss(rpn_cls, rpn_reg, anchors, batch['gt_bboxes'],
                              batch['gt_valid'], batch['img_shape'],
                              self.rpn_train_cfg, priorities=pri.get('rpn'),
                              generator=generator)
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
        maps = self.roi_maps(feat)
        with record_function('step/roi_align_fwd'):
            crops = self.roi_extract(maps, sampled.rois)
        with record_function('step/res5_shared_head'):
            res5 = self.shared_head(crops)
        with record_function('step/bbox_head_and_loss'):
            cls, reg, _ = self.bbox_head(res5)
            losses.update(bbox_loss(cls, reg, sampled, self.num_classes,
                                    self.roi_train_cfg))
        if self.with_mask:
            with record_function('step/mask_targets'):
                targets = mask_targets_from_box_frame(
                    batch['gt_masks'], batch['gt_bboxes'], sampled.rois,
                    sampled.matched_gt, self.mask_size)
            with record_function('step/mask_head_and_loss'):
                pos_w = (sampled.is_pos & sampled.label_valid).float()
                losses.update(mask_loss(self.mask_head(res5), targets,
                                        sampled.labels, pos_w))
        return losses

    @torch.inference_mode()
    def predict(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """simple_test flow: proposals → RoIAlign, res5, box head →
        per-class NMS; with `with_mask`, `masks` (B, D, 14, 14) from the
        detections' own RoIAlign and res5, padded rows included."""
        feat = self.extract_feat(batch['image'].float())
        rpn_cls, rpn_reg, anchors = self.rpn_outputs(feat)
        proposals, _, prop_valid = rpn_proposals(
            rpn_cls, rpn_reg, anchors, batch['img_shape'], self.rpn_test_cfg)
        maps = self.roi_maps(feat)
        out = roi_head_predict(
            self.roi_box_head, maps, proposals, prop_valid,
            batch['img_shape'], self.num_classes, reg_class_agnostic=False,
            target_stds=self.roi_train_cfg.target_stds,
            use_sigmoid_cls=self.roi_train_cfg.use_sigmoid_cls,
            cfg=self.roi_test_cfg, roi_extractor=self.roi_extract)
        if self.with_mask:
            out['masks'] = self.mask_predict(maps, out)
        return out

    def mask_predict(self, maps: torch.Tensor, out: Dict[str, torch.Tensor]
                     ) -> torch.Tensor:
        """The mask branch on the detections of `out`: RoIAlign, res5, mask
        head, own-class sigmoid."""
        crops = self.roi_extract(maps, out['dets'][..., :4].contiguous())
        return select_class_masks(self.mask_head(self.shared_head(crops)),
                                  out['labels'], self.num_classes)

    def forward(self, batch: Dict[str, torch.Tensor], train: bool = True,
                generator: Optional[torch.Generator] = None,
                sampler_priorities: Optional[Dict[str, torch.Tensor]] = None):
        """The loss dict with `train`, else `predict`."""
        if train:
            return self.loss(batch, generator, sampler_priorities)
        return self.predict(batch)
