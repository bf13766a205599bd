"""The multi-level dense heads' machinery (counterpart of the JAX
package's `models/dense_heads/anchor_head.py`): `MultiAnchorConfig`,
`flatten_level_preds`, RetinaNet's loss `dense_focal_anchor_loss` (focal
or GHM-C classification, smooth-L1 boxes) and the single-stage test path
(`dense_predict`, and `dense_anchor_predict` for anchor deltas).

Every level has a static shape, so the per-level lists flatten into one
(B, N, ·) tensor (each level NHWC location-major, anchor-minor, the
levels in order) and the single-level assign and loss code runs on it.
The losses' normalizers are global-batch counts (`parallel/batch.py`), so
several ranks train on the loss one process computes on their rows.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ...core.anchors.anchor_generator import (AnchorGenerator,
                                              anchor_inside_flags)
from ...core.bbox.assigners import max_iou_assign
from ...core.bbox.transforms import bbox2delta, clip_boxes, delta2bbox
from ...core.post.nms import NEG_INF, batched_nms, topk_stable
from ...parallel.batch import batch_mean, batch_total
from ..losses import sigmoid_focal_loss, smooth_l1_loss
from ..losses.focal_loss import ghm_classification_loss


class MultiAnchorConfig(NamedTuple):
    """Multi-level anchors (RetinaNet: `octave_base_scale` 4, three scales
    an octave, ratios 0.5, 1, 2, strides 8..128)."""
    strides: Tuple[int, ...] = (8, 16, 32, 64, 128)
    ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    octave_base_scale: int = 4
    scales_per_octave: int = 3

    @property
    def num_anchors(self) -> int:
        return len(self.ratios) * self.scales_per_octave

    @property
    def scales(self) -> Tuple[float, ...]:
        """The octave scales, as `AnchorGenerator` computes them."""
        return tuple(2 ** (i / self.scales_per_octave)
                     * self.octave_base_scale
                     for i in range(self.scales_per_octave))

    def flat_anchors(self, featmap_sizes: Sequence[Tuple[int, int]]
                     ) -> np.ndarray:
        return _level_anchors_np(self.strides, self.ratios, self.scales,
                                 tuple(map(tuple, featmap_sizes)))[0]


@functools.lru_cache(maxsize=32)
def _level_anchors_np(strides: Tuple[int, ...], ratios: Tuple[float, ...],
                      scales: Tuple[float, ...],
                      sizes: Tuple[Tuple[int, int], ...]):
    levels = AnchorGenerator(strides=list(strides), ratios=list(ratios),
                             scales=list(scales)).grid_priors(list(sizes))
    return np.concatenate(levels, axis=0), tuple(len(a) for a in levels)


def level_anchors(strides: Sequence[int], ratios: Sequence[float],
                  scales: Sequence[float], sizes, device
                  ) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """The flat anchors (N, 4) of FPN levels of (h, w) `sizes` and the
    levels' anchor counts (cached on the host by the sizes)."""
    anchors, counts = _level_anchors_np(
        tuple(strides), tuple(ratios), tuple(scales),
        tuple(tuple(s) for s in sizes))
    return torch.from_numpy(anchors).to(device), counts


def flatten_level_preds(preds: Sequence[torch.Tensor], channels: int
                        ) -> torch.Tensor:
    """[(B, H_i, W_i, A*channels)] NHWC → (B, ΣH_i·W_i·A, channels), each
    level location-major, anchor-minor, the levels in order."""
    b = preds[0].shape[0]
    return torch.cat([p.reshape(b, -1, channels) for p in preds], dim=1)


class DenseAnchorTrainConfig(NamedTuple):
    pos_iou_thr: float = 0.5
    neg_iou_thr: float = 0.4
    min_pos_iou: float = 0.0
    match_low_quality: bool = True
    allowed_border: int = -1
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    target_means: Tuple[float, ...] = (0., 0., 0., 0.)
    target_stds: Tuple[float, ...] = (1., 1., 1., 1.)
    # 'focal' (RetinaNet) | 'ghm' (GHM-C, the `configs/ghm` row: the
    # classification re-weighted by inverse gradient density, normalized
    # by each image's valid count and averaged over the images)
    loss_cls: str = 'focal'


def dense_focal_anchor_loss(cls_logits: torch.Tensor,
                            reg_preds: torch.Tensor,
                            anchors: torch.Tensor,
                            gt_bboxes: torch.Tensor,
                            gt_labels: torch.Tensor,
                            gt_valid: torch.Tensor,
                            img_shape: torch.Tensor,
                            num_classes: int,
                            cfg: DenseAnchorTrainConfig =
                            DenseAnchorTrainConfig()
                            ) -> Dict[str, torch.Tensor]:
    """RetinaNet's loss: max-IoU assignment of the (N, 4) anchors to each
    image's gts, the focal loss over every assigned or negative anchor
    (or GHM-C) and smooth-L1 (β 1/9) on the positives' deltas, both over
    the batch's positive count (GHM-C: the mean of its per-image values).
    cls_logits (B, N, C), reg_preds (B, N, 4)."""
    inside = anchor_inside_flags(anchors, img_shape[:, None, :],
                                 cfg.allowed_border)
    assign = max_iou_assign(
        anchors, gt_bboxes, gt_valid, gt_labels,
        pos_iou_thr=cfg.pos_iou_thr, neg_iou_thr=cfg.neg_iou_thr,
        min_pos_iou=cfg.min_pos_iou,
        match_low_quality=cfg.match_low_quality, prior_valid=inside)
    pos = assign.assigned_gt_inds > 0
    neg = assign.assigned_gt_inds == 0
    labels = torch.where(pos, assign.labels,
                         torch.full_like(assign.labels, num_classes))
    if cfg.loss_cls == 'ghm':
        cls_loss = batch_mean(ghm_classification_loss(cls_logits, labels,
                                                      pos | neg))
    else:
        cls_loss = sigmoid_focal_loss(
            cls_logits, labels, weight=(pos | neg).float(),
            gamma=cfg.focal_gamma, alpha=cfg.focal_alpha, reduction='sum')
    g = gt_bboxes.shape[1]
    matched = (assign.assigned_gt_inds - 1).clamp(0, g - 1)
    matched_gt = torch.gather(gt_bboxes, 1,
                              matched[..., None].expand(*matched.shape, 4))
    targets = bbox2delta(anchors, matched_gt, cfg.target_means,
                         cfg.target_stds)
    reg_loss = smooth_l1_loss(reg_preds.float(), targets,
                              weight=pos[..., None].float(), beta=1.0 / 9.0,
                              reduction='sum')
    denom = torch.clamp(batch_total(pos.sum().float()), min=1.0)
    return dict(loss_cls=cls_loss if cfg.loss_cls == 'ghm'
                else cls_loss / denom, loss_bbox=reg_loss / denom)


class DensePredictConfig(NamedTuple):
    nms_pre: int = 1000
    score_thr: float = 0.05
    nms_iou_threshold: float = 0.5
    max_per_img: int = 100
    nms_tile: int = 256
    target_stds: Tuple[float, ...] = (1., 1., 1., 1.)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, D), idx (B, K) → (B, K, D)."""
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def dense_predict(probs: torch.Tensor,
                  decode: Callable[[torch.Tensor], torch.Tensor],
                  img_shape: torch.Tensor,
                  num_classes: int,
                  cfg: DensePredictConfig = DensePredictConfig()
                  ) -> Dict[str, torch.Tensor]:
    """The single-stage test path: per image, the top `nms_pre` of the
    (B, N, C) prior x class scores `probs` over `score_thr` (the rest at
    NEG_INF, ties to the lower flat index), the chosen priors' boxes
    `decode(prior index (B, K))` (B, K, 4) clipped to the image, then
    class-aware NMS and the top `max_per_img` → dict(dets (B, M, 5), labels
    (B, M), valid (B, M)), zeroed past the valid rows."""
    top, idx = top_scores(probs, cfg)
    labels = idx % num_classes
    boxes = clip_boxes(decode(idx // num_classes),
                       img_shape[:, None, :].float())
    return nms_detections(boxes, top, labels, cfg)


def top_scores(probs: torch.Tensor, cfg: DensePredictConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top `nms_pre` of each image's (B, N, C) scores over `score_thr`
    (the rest at NEG_INF, ties to the lower flat index) and their flat
    indices."""
    flat = probs.reshape(probs.shape[0], -1)
    flat = torch.where(flat > cfg.score_thr, flat, flat.new_tensor(NEG_INF))
    return topk_stable(flat, min(cfg.nms_pre, flat.shape[-1]))


def nms_detections(boxes: torch.Tensor, scores: torch.Tensor,
                   labels: torch.Tensor, cfg: DensePredictConfig
                   ) -> Dict[str, torch.Tensor]:
    """Class-aware NMS of (B, K, 4) boxes with (B, K) scores and labels,
    then the top `max_per_img` → dict(dets (B, M, 5), labels (B, M), valid
    (B, M)), zeroed past the valid rows (scores over NEG_INF / 2)."""
    keep, _ = batched_nms(boxes, scores, labels, cfg.nms_iou_threshold,
                          cfg.nms_tile)
    kept = torch.where(keep, scores, scores.new_tensor(NEG_INF))
    m = min(cfg.max_per_img, scores.shape[-1])
    sc, sel = topk_stable(kept, m)
    valid = sc > NEG_INF / 2
    dets = torch.cat([_rows(boxes, sel) * valid[..., None],
                      torch.where(valid, sc, sc.new_zeros(()))[..., None]],
                     dim=-1)
    out_labels = torch.where(valid, torch.gather(labels, 1, sel),
                             torch.zeros_like(sel))
    return dict(dets=dets, labels=out_labels, valid=valid)


def dense_anchor_predict(cls_logits: torch.Tensor,
                         reg_preds: torch.Tensor,
                         anchors: torch.Tensor,
                         img_shape: torch.Tensor,
                         num_classes: int,
                         cfg: DensePredictConfig = DensePredictConfig()
                         ) -> Dict[str, torch.Tensor]:
    """`dense_predict` on the anchors' sigmoid class scores, the boxes
    decoded at `target_stds`. cls_logits (B, N, C), reg_preds (B, N, 4),
    anchors (N, 4) or per image (B, N, 4), img_shape (B, 2)."""
    if anchors.dim() == 2:
        anchors = anchors.expand(cls_logits.shape[0], *anchors.shape)
    reg = reg_preds.float()
    return dense_predict(
        torch.sigmoid(cls_logits.float()),
        lambda a_idx: delta2bbox(_rows(anchors, a_idx), _rows(reg, a_idx),
                                 stds=cfg.target_stds),
        img_shape, num_classes, cfg)
