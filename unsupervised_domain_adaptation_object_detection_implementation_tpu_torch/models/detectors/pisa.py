"""PISA, prime sample attention (counterpart of the JAX package's
`models/detectors/pisa.py`; reference `mmdet/models/dense_heads/
pisa_retinanet_head.py`, `roi_heads/pisa_roi_head.py`,
`models/losses/pisa_loss.py`).

The positives' classification losses carry ISR-P weights (their IoU
rank within their class) and the regression carries CARL weights (the
own-class score), `models/losses/extra_losses.py`; the assignment, the
samplers and the heads are the parents' (`RetinaNet`, `FasterRCNNFPN`,
`MaskRCNN`, whose mask branch runs unchanged on the same sampled RoIs).

As in the JAX package, and unlike mmdet's `carl_loss`, CARL's score is
detached: the weight is a constant of the step, so no regression gradient
reaches the classifier. The SSD forms wait for the SSD detectors.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.profiler import record_function

from ...core.anchors.anchor_generator import anchor_inside_flags
from ...core.bbox.assigners import max_iou_assign
from ...core.bbox.iou import bbox_overlaps
from ...core.bbox.transforms import bbox2delta, delta2bbox
from ...parallel.batch import batch_total
from ...utils.registry import DETECTORS
from ..dense_heads.anchor_head import DenseAnchorTrainConfig, _rows
from ..losses import sigmoid_focal_loss, smooth_l1_loss, softmax_cross_entropy
from ..losses.extra_losses import carl_weights, isr_p_weights
from ..roi_heads.standard_roi_head import SampledRoIs
from .faster_rcnn_fpn import FasterRCNNFPN
from .mask_rcnn import MaskRCNN
from .retinanet import RetinaNet


def aligned_ious(boxes: torch.Tensor, gts: torch.Tensor) -> torch.Tensor:
    """The IoU of each (..., 4) box with its own (..., 4) gt, as the JAX
    package computes it (`bbox_overlaps` of the pair)."""
    return bbox_overlaps(boxes[..., None, :], gts[..., None, :])[..., 0, 0]


def pisa_anchor_loss(cls_logits: torch.Tensor, reg_preds: torch.Tensor,
                     anchors: torch.Tensor, gt_bboxes: torch.Tensor,
                     gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                     img_shape: torch.Tensor, num_classes: int,
                     cfg: DenseAnchorTrainConfig = DenseAnchorTrainConfig(),
                     isr_k: float = 2.0, isr_bias: float = 0.0,
                     carl_k: float = 1.0, carl_bias: float = 0.2
                     ) -> Dict[str, torch.Tensor]:
    """RetinaNet's focal / smooth-L1 (β 1/9) anchor loss with the positives'
    classification weighted by ISR-P (ranked on the detached decode's IoU
    with the matched gt) and their regression by CARL, over the batch's
    positive count. cls_logits (B, N, C), reg_preds (B, N, 4)."""
    c = num_classes
    with torch.no_grad():
        inside = anchor_inside_flags(anchors, img_shape[:, None, :],
                                     cfg.allowed_border)
        assign = max_iou_assign(
            anchors, gt_bboxes, gt_valid, gt_labels,
            pos_iou_thr=cfg.pos_iou_thr, neg_iou_thr=cfg.neg_iou_thr,
            min_pos_iou=cfg.min_pos_iou,
            match_low_quality=cfg.match_low_quality, prior_valid=inside)
        pos = assign.assigned_gt_inds > 0
        neg = assign.assigned_gt_inds == 0
        own = assign.labels.long().clamp(0, c - 1)
        labels = torch.where(pos, assign.labels.long(),
                             torch.full_like(own, c))
        m = (assign.assigned_gt_inds - 1).clamp(0, gt_bboxes.shape[1] - 1)
        matched_gt = _rows(gt_bboxes, m)
        boxes = delta2bbox(anchors, reg_preds.float(), cfg.target_means,
                           cfg.target_stds)
        ious = aligned_ious(boxes, matched_gt)
        with record_function('step/isr_p'):
            isr = isr_p_weights(torch.zeros_like(ious), ious, own, pos, c,
                                k=isr_k, bias=isr_bias)
        cls_w = torch.where(pos, isr, neg.float())
        p_own = torch.gather(torch.sigmoid(cls_logits.float()), -1,
                             own[..., None])[..., 0]
        carl = carl_weights(p_own, pos, k=carl_k, bias=carl_bias)
        targets = bbox2delta(anchors, matched_gt, cfg.target_means,
                             cfg.target_stds)
    cls_loss = sigmoid_focal_loss(cls_logits, labels, weight=cls_w,
                                  gamma=cfg.focal_gamma,
                                  alpha=cfg.focal_alpha, reduction='sum')
    reg_loss = smooth_l1_loss(reg_preds, targets,
                              weight=(carl * pos)[..., None], beta=1.0 / 9.0,
                              reduction='sum')
    denom = torch.clamp(batch_total(pos.sum().float()), min=1.0)
    return dict(loss_cls=cls_loss / denom, loss_bbox=reg_loss / denom)


@DETECTORS.register_module()
class PISARetinaNet(RetinaNet):
    """`RetinaNet` trained with `pisa_anchor_loss`."""

    def loss(self, batch, generator=None, sampler_priorities=None):
        cls, reg, anchors = self._flat(batch['image'])
        with record_function('step/dense_loss'):
            return pisa_anchor_loss(
                cls, reg, anchors, batch['gt_bboxes'].float(),
                batch['gt_labels'], batch['gt_valid'], batch['img_shape'],
                self.num_classes, self.train_cfg)


def pisa_roi_losses(cls_scores: torch.Tensor, reg_preds: torch.Tensor,
                    sampled: SampledRoIs, gt_bboxes: torch.Tensor,
                    num_classes: int,
                    target_stds=(0.1, 0.1, 0.2, 0.2)
                    ) -> Dict[str, torch.Tensor]:
    """The sampled RoIs' softmax CE, the positives' weighted by ISR-P (on
    the detached class-specific decode's IoU with the matched gt), and
    their smooth-L1 (β 1) weighted by CARL (the detached softmax score of
    their class), both over the batch's sampled count."""
    c = num_classes
    b, s = sampled.labels.shape
    if reg_preds.shape[-1] == 4:
        reg_sel = reg_preds
    else:
        lbl = sampled.labels.clamp(0, c - 1)
        reg_sel = torch.gather(reg_preds.reshape(b, s, c, 4), 2,
                               lbl[..., None, None].expand(b, s, 1, 4)
                               )[..., 0, :]
    is_pos, lvalid = sampled.is_pos, sampled.label_valid
    with torch.no_grad():
        own = sampled.labels.clamp(0, c - 1)
        boxes = delta2bbox(sampled.rois, reg_sel.float(), stds=target_stds)
        ious = aligned_ious(boxes, _rows(gt_bboxes, sampled.matched_gt))
        with record_function('step/isr_p'):
            isr = isr_p_weights(torch.zeros_like(ious), ious, own, is_pos, c)
        w = torch.where(is_pos, isr, lvalid.float())
        p_own = torch.gather(torch.softmax(cls_scores.float(), -1), -1,
                             own[..., None])[..., 0]
        carl = carl_weights(p_own, is_pos)
    cls_l = (softmax_cross_entropy(cls_scores, sampled.labels) * w).sum()
    reg_l = smooth_l1_loss(reg_sel, sampled.reg_targets,
                           weight=(carl * is_pos)[..., None], beta=1.0,
                           reduction='sum')
    denom = torch.clamp(batch_total(lvalid.sum().float()), min=1.0)
    return dict(loss_cls=cls_l / denom, loss_bbox=reg_l / denom)


class _PISARoIMixin:
    """The box losses of `FasterRCNNFPN._det_losses` replaced by
    `pisa_roi_losses` (which read the batch's gt boxes); the RPN, the
    samplers and, for Mask R-CNN, the mask branch are the parent's."""

    def _det_losses(self, batch, generator, sampler_priorities):
        maps, losses, sampled, _ = self._sample(batch, generator,
                                                sampler_priorities)
        with record_function('step/roi_align_fwd'):
            roi_feats = self.roi_extract(maps, sampled.rois)
        with record_function('step/bbox_head_and_loss'):
            cls_s, reg_s, _ = self.bbox_head(roi_feats)
            losses.update(pisa_roi_losses(
                cls_s, reg_s, sampled, batch['gt_bboxes'].float(),
                self.num_classes, self.roi_train_cfg.target_stds))
        return losses, sampled, maps


@DETECTORS.register_module()
class PISAFasterRCNN(_PISARoIMixin, FasterRCNNFPN):
    """`FasterRCNNFPN` with `pisa_roi_losses`."""


@DETECTORS.register_module()
class PISAMaskRCNN(_PISARoIMixin, MaskRCNN):
    """`MaskRCNN` with `pisa_roi_losses` and the mask branch on the same
    sampled RoIs."""
