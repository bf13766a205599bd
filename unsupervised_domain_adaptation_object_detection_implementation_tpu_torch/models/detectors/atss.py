"""ATSS (counterpart of the JAX package's `models/detectors/atss.py`): a
RetinaNet-shaped head with one square anchor a location (8 x stride),
adaptive training sample selection (`core/bbox/atss_assigner.py`), GIoU
boxes weighted by the centerness target and a centerness branch on the
reg tower. `ATSSHead` is also PAA's head."""

from __future__ import annotations

import functools
from typing import Any, Dict, Sequence, Tuple

import torch
from torch.profiler import record_function

from ...core.bbox.atss_assigner import atss_assign
from ...core.bbox.transforms import delta2bbox
from ...parallel.batch import batch_total
from ...utils.registry import DETECTORS, HEADS
from ..dense_heads.anchor_head import (DensePredictConfig, _rows,
                                       dense_predict, flatten_level_preds,
                                       level_anchors)
from ..layers.precision import Conv2d
from ..losses import binary_cross_entropy, giou_loss, sigmoid_focal_loss
from ..necks.build import make_fpn_neck
from .fcos import centerness_target
from .retinanet import SingleStage, TowerHead, _nhwc


@HEADS.register_module()
class ATSSHead(TowerHead):
    """`atss_cls` on the cls tower; `atss_reg` (its deltas times
    `scale_{lvl}`, float32) and `atss_centerness` on the reg tower."""

    def __init__(self, num_classes: int = 80, feat_channels: int = 256,
                 stacked_convs: int = 4, in_channels: int = 256,
                 num_levels: int = 5, dtype: torch.dtype = torch.float32):
        super().__init__(feat_channels, stacked_convs, in_channels,
                         num_levels, dtype=dtype)
        conv = functools.partial(Conv2d, compute_dtype=dtype)
        self.atss_cls = conv(feat_channels, num_classes, 3, padding=1)
        self.atss_reg = conv(feat_channels, 4, 3, padding=1)
        self.atss_centerness = conv(feat_channels, 1, 3, padding=1)

    def cls_output(self):
        return self.atss_cls

    def outputs(self, c, r, lvl):
        return (_nhwc(self.atss_cls(c).float()),
                _nhwc(self.atss_reg(r).float() * self.scale(lvl)),
                _nhwc(self.atss_centerness(r).float()))


def anchor_centers(anchors: torch.Tensor) -> torch.Tensor:
    """(N, 4) boxes → (N, 2) centres."""
    return torch.stack([(anchors[:, 0] + anchors[:, 2]) * 0.5,
                        (anchors[:, 1] + anchors[:, 3]) * 0.5], -1)


def atss_loss(cls_logits, reg_deltas, ctr_logits, anchors,
              num_level_anchors: Sequence[int], gt_bboxes, gt_labels,
              gt_valid, num_classes: int, topk: int = 9
              ) -> Dict[str, torch.Tensor]:
    """ATSS's losses: focal over every anchor, 2 x GIoU of the positives'
    decoded boxes weighted by the centerness target over the batch's Σ
    centerness, BCE of the centerness over the positive count.
    cls_logits (B, N, C), reg_deltas (B, N, 4), ctr_logits (B, N, 1),
    anchors (N, 4)."""
    assign = atss_assign(anchors, num_level_anchors, gt_bboxes, gt_valid,
                         gt_labels, topk)
    pos = assign.assigned_gt_inds > 0
    labels = torch.where(pos, assign.labels,
                         torch.full_like(assign.labels, num_classes))
    cls_l = sigmoid_focal_loss(cls_logits, labels, reduction='sum')
    matched = (assign.assigned_gt_inds - 1).clamp(0, gt_bboxes.shape[1] - 1)
    gt_m = _rows(gt_bboxes, matched)
    boxes = delta2bbox(anchors, reg_deltas)
    ctr = anchor_centers(anchors)
    ctr_t = centerness_target(torch.stack(
        [ctr[:, 0] - gt_m[..., 0], ctr[:, 1] - gt_m[..., 1],
         gt_m[..., 2] - ctr[:, 0], gt_m[..., 3] - ctr[:, 1]], -1))
    pos_f = pos.float()
    reg_l = giou_loss(boxes, gt_m, weight=pos_f * ctr_t, reduction='sum')
    ctr_l = binary_cross_entropy(ctr_logits[..., 0], ctr_t, weight=pos_f,
                                 reduction='sum')
    denom = torch.clamp(batch_total(pos_f.sum()), min=1.0)
    ctr_sum = torch.clamp(batch_total((pos_f * ctr_t).sum()), min=1e-6)
    return dict(loss_cls=cls_l / denom, loss_bbox=2.0 * reg_l / ctr_sum,
                loss_centerness=ctr_l / denom)


class _ATSSBase(SingleStage):
    """P3–P7 (extra convs on C5), `ATSSHead`, one 8 x stride square anchor
    a location."""

    anchor_scale = 8.0

    def __init__(self, num_classes: int, backbone_depth: int,
                 backbone_cfg: Any, frozen_stages: int,
                 strides: Tuple[int, ...], test_cfg: DensePredictConfig,
                 dtype: torch.dtype):
        super().__init__(num_classes, backbone_depth, backbone_cfg,
                         frozen_stages, dtype)
        self.strides = tuple(strides)
        self.test_cfg = test_cfg
        self.neck = make_fpn_neck('FPN',
                                  in_channels=self.backbone.stage_channels(),
                                  out_channels=256, num_outs=5, start_level=1,
                                  add_extra_convs='on_input', dtype=dtype)
        self.bbox_head = ATSSHead(num_classes=num_classes,
                                  num_levels=len(self.strides), dtype=dtype)

    def _flat(self, image):
        """→ cls (B, N, C), reg (B, N, 4), ctr (B, N, 1), anchors (N, 4),
        the levels' anchor counts."""
        feats, sizes = self._levels(image)
        cls_lv, reg_lv, ctr_lv = self.bbox_head(feats)
        cls = flatten_level_preds(cls_lv, self.num_classes)
        reg = flatten_level_preds(reg_lv, 4)
        ctr = flatten_level_preds(ctr_lv, 1)
        anchors, counts = level_anchors(self.strides, (1.0,),
                                        (self.anchor_scale,), sizes,
                                        image.device)
        return cls, reg, ctr, anchors, counts

    def _predict(self, probs, reg, anchors, img_shape):
        return dense_predict(
            probs, lambda idx: delta2bbox(anchors[idx], _rows(reg, idx)),
            img_shape, self.num_classes, self.test_cfg)


@DETECTORS.register_module()
class ATSS(_ATSSBase):
    """ATSS: `atss_loss`; `predict` scores sigmoid(cls) · sigmoid(ctr)."""

    def __init__(self, num_classes: int = 80, backbone_depth: int = 50,
                 backbone_cfg: Any = None, frozen_stages: int = 1,
                 strides: Tuple[int, ...] = (8, 16, 32, 64, 128),
                 topk: int = 9,
                 test_cfg: DensePredictConfig = DensePredictConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__(num_classes, backbone_depth, backbone_cfg,
                         frozen_stages, strides, test_cfg, dtype)
        self.topk = topk

    def loss(self, batch, generator=None, sampler_priorities=None):
        cls, reg, ctr, anchors, counts = self._flat(batch['image'])
        with record_function('step/dense_loss'):
            return atss_loss(cls, reg, ctr, anchors, counts,
                             batch['gt_bboxes'].float(), batch['gt_labels'],
                             batch['gt_valid'], self.num_classes, self.topk)

    @torch.inference_mode()
    def predict(self, batch):
        cls, reg, ctr, anchors, _ = self._flat(batch['image'])
        return self._predict(torch.sigmoid(cls) * torch.sigmoid(ctr), reg,
                             anchors, batch['img_shape'])
