"""GFL (counterpart of the JAX package's `models/detectors/gfl.py`): ATSS
assignment, the classification trained with the quality focal loss on
the positives' IoU, each box side a distribution over `reg_max + 1` bins
(the distribution focal loss) decoded as its expectation times the
stride, and GIoU.

Two behaviours of the JAX package that mmdet's GFL does not have, copied
as they are:

- the DFL target clips the *pixel* distances at `reg_max - 0.1` and then
  divides by the stride (mmdet divides first), so at stride 8 a target
  never passes ~2 bins;
- the quality (the IoU of the decoded box with its gt) is not detached: the
  gradient flows through the QFL target, through the GIoU weight and
  through the normalizer Σ quality, which under several ranks is summed by
  a differentiable all-reduce (`parallel/batch.py:all_reduce_sum`).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ...core.bbox.atss_assigner import atss_assign
from ...core.bbox.coders import bbox2distance, distance2bbox
from ...core.bbox.iou import bbox_overlaps
from ...parallel.batch import all_reduce_sum, batch_total
from ...utils.registry import DETECTORS, HEADS
from ..dense_heads.anchor_head import (DensePredictConfig, _rows,
                                       dense_predict, flatten_level_preds,
                                       level_anchors)
from ..layers.precision import Conv2d
from ..losses import giou_loss
from ..losses.gfocal_loss import distribution_focal_loss, quality_focal_loss
from ..losses.utils import jax_max
from ..necks.build import make_fpn_neck
from .atss import anchor_centers
from .retinanet import SingleStage, TowerHead, _nhwc


@HEADS.register_module()
class GFLHead(TowerHead):
    """`gfl_cls` on the cls tower; `gfl_reg`, 4 x (reg_max + 1) bin logits
    times `scale_{lvl}` (float32), on the reg tower."""

    def __init__(self, num_classes: int = 80, feat_channels: int = 256,
                 stacked_convs: int = 4, in_channels: int = 256,
                 num_levels: int = 5, reg_max: int = 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__(feat_channels, stacked_convs, in_channels,
                         num_levels, dtype=dtype)
        conv = functools.partial(Conv2d, compute_dtype=dtype)
        self.gfl_cls = conv(feat_channels, num_classes, 3, padding=1)
        self.gfl_reg = conv(feat_channels, 4 * (reg_max + 1), 3, padding=1)

    def cls_output(self):
        return self.gfl_cls

    def outputs(self, c, r, lvl):
        return (_nhwc(self.gfl_cls(c).float()),
                _nhwc(self.gfl_reg(r).float() * self.scale(lvl)))


def dist_expectation(reg_logits: torch.Tensor, reg_max: int) -> torch.Tensor:
    """(..., 4 (reg_max + 1)) bin logits → (..., 4) expected distances in
    bins."""
    p = torch.softmax(reg_logits.reshape(*reg_logits.shape[:-1], 4,
                                         reg_max + 1), dim=-1)
    bins = torch.arange(reg_max + 1, dtype=torch.float32,
                        device=reg_logits.device)
    return (p * bins).sum(-1)


def aligned_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of each (..., 4) box of `a` with its counterpart in `b`, as the
    JAX package's `bbox_overlaps` of the pair (differentiable)."""
    return bbox_overlaps(a[..., None, :], b[..., None, :])[..., 0, 0]


def gfl_loss(cls_logits, reg_logits, anchors,
             num_level_anchors: Sequence[int], strides, gt_bboxes, gt_labels,
             gt_valid, num_classes: int, reg_max: int = 16, topk: int = 9
             ) -> Dict[str, torch.Tensor]:
    """GFL's losses: QFL over every anchor (the target the positives'
    IoU quality), 2 x GIoU of the positives weighted by the quality over
    the batch's Σ quality, DFL of the positives' four sides at 1/4 over
    4 x the positive count. cls_logits (B, N, C), reg_logits (B, N,
    4 (reg_max + 1)), anchors (N, 4), strides (N,)."""
    assign = atss_assign(anchors, num_level_anchors, gt_bboxes, gt_valid,
                         gt_labels, topk)
    pos = assign.assigned_gt_inds > 0
    matched = (assign.assigned_gt_inds - 1).clamp(0, gt_bboxes.shape[1] - 1)
    gt_m = _rows(gt_bboxes, matched)
    centers = anchor_centers(anchors)
    dist = dist_expectation(reg_logits, reg_max)
    boxes = distance2bbox(centers, dist * strides[:, None])
    iou_q = aligned_iou(boxes, gt_m)
    labels = torch.where(pos, assign.labels,
                         torch.full_like(assign.labels, num_classes))
    quality = torch.where(pos, iou_q, iou_q.new_zeros(()))
    cls_l = quality_focal_loss(cls_logits, labels, quality, reduction='sum')
    target = bbox2distance(centers, gt_m, max_dist=float(reg_max)) / \
        strides[:, None]
    target = target.clamp(0, reg_max - 1e-3)
    pos_f = pos.float()
    dfl = distribution_focal_loss(
        reg_logits.reshape(*reg_logits.shape[:-1], 4, reg_max + 1), target,
        weight=pos_f[..., None].expand(*pos.shape, 4), reduction='sum')
    reg_l = giou_loss(boxes, gt_m, weight=pos_f * quality, reduction='sum')
    denom = torch.clamp(batch_total(pos_f.sum()), min=1.0)
    q_sum = jax_max(all_reduce_sum((pos_f * quality).sum()), 1e-6)
    return dict(loss_cls=cls_l / denom, loss_bbox=2.0 * reg_l / q_sum,
                loss_dfl=0.25 * dfl / (4.0 * denom))


@DETECTORS.register_module()
class GFL(SingleStage):
    """GFL: P3–P7 (extra convs on C5), `GFLHead`, one `anchor_scale` x
    stride square anchor a location (8, the COCO config's; `anchor_scale=3`
    fits the synth set's 24–34 px shapes), `gfl_loss`; `predict` scores
    sigmoid(cls)."""

    def __init__(self, num_classes: int = 80, backbone_depth: int = 50,
                 backbone_cfg: Any = None, frozen_stages: int = 1,
                 strides: Tuple[int, ...] = (8, 16, 32, 64, 128),
                 anchor_scale: float = 8.0, reg_max: int = 16, topk: int = 9,
                 test_cfg: DensePredictConfig = DensePredictConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__(num_classes, backbone_depth, backbone_cfg,
                         frozen_stages, dtype)
        self.strides = tuple(strides)
        self.anchor_scale = anchor_scale
        self.reg_max = reg_max
        self.topk = topk
        self.test_cfg = test_cfg
        self.neck = make_fpn_neck('FPN',
                                  in_channels=self.backbone.stage_channels(),
                                  out_channels=256, num_outs=5, start_level=1,
                                  add_extra_convs='on_input', dtype=dtype)
        self.bbox_head = GFLHead(num_classes=num_classes,
                                 num_levels=len(self.strides),
                                 reg_max=reg_max, dtype=dtype)

    def _flat(self, image):
        """→ cls (B, N, C), reg (B, N, 4 (reg_max + 1)), anchors (N, 4),
        strides (N,), the levels' anchor counts."""
        feats, sizes = self._levels(image)
        cls_lv, reg_lv = self.bbox_head(feats)
        cls = flatten_level_preds(cls_lv, self.num_classes)
        reg = flatten_level_preds(reg_lv, 4 * (self.reg_max + 1))
        anchors, counts = level_anchors(self.strides, (1.0,),
                                        (self.anchor_scale,), sizes,
                                        image.device)
        strides = torch.from_numpy(np.repeat(
            np.float32(self.strides), counts)).to(image.device)
        return cls, reg, anchors, strides, counts

    def loss(self, batch, generator=None, sampler_priorities=None):
        cls, reg, anchors, strides, counts = self._flat(batch['image'])
        with record_function('step/dense_loss'):
            return gfl_loss(cls, reg, anchors, counts, strides,
                            batch['gt_bboxes'].float(), batch['gt_labels'],
                            batch['gt_valid'], self.num_classes,
                            self.reg_max, self.topk)

    @torch.inference_mode()
    def predict(self, batch):
        cls, reg, anchors, strides, _ = self._flat(batch['image'])
        centers = anchor_centers(anchors)

        def decode(idx):
            d = dist_expectation(_rows(reg, idx), self.reg_max)
            return distance2bbox(centers[idx], d * strides[idx][..., None])

        return dense_predict(torch.sigmoid(cls), decode, batch['img_shape'],
                             self.num_classes, self.test_cfg)
