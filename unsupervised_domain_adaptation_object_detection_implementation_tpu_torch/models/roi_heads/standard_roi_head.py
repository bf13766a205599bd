"""RoI head training and inference (counterpart of the JAX package's
`models/roi_heads/standard_roi_head.py`: `sample_rois`, `bbox_loss`,
`extract_roi_feats`, `extract_roi_feats_fpn` and `roi_head_predict`).

RoIs stay a padded (B, S, 4) tensor with validity masks; gt boxes join the
proposals as candidates (`add_gt_as_proposals`).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from ...core.bbox.assigners import max_iou_assign
from ...core.bbox.samplers import random_sample
from ...core.bbox.transforms import bbox2delta, delta2bbox
from ...core.post.nms import multiclass_nms
from ...ops.roi_align import batched_roi_align, batched_roi_align_fpn
from ..losses import binary_cross_entropy, cross_entropy, smooth_l1_loss


class RoITrainConfig(NamedTuple):
    """The configs' `train_cfg.rcnn` and bbox-head settings. Only the
    random sampler and the smooth-L1 regression loss are ported; the other
    values raise where they are used."""
    pos_iou_thr: float = 0.5
    neg_iou_thr: float = 0.5
    min_pos_iou: float = 0.5
    match_low_quality: bool = False
    num_samples: int = 512
    pos_fraction: float = 0.25
    add_gt_as_proposals: bool = True
    target_means: Tuple[float, ...] = (0., 0., 0., 0.)
    target_stds: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)
    use_sigmoid_cls: bool = True
    sampler_type: str = 'random'
    reg_loss: str = 'l1'
    reg_loss_weight: float = 1.0


class RoITestConfig(NamedTuple):
    score_thr: float = 0.05
    nms_iou_threshold: float = 0.5
    max_per_img: int = 100
    nms_pre: int = 1024
    nms_tile: int = 256
    nms_type: str = 'nms'


class SampledRoIs(NamedTuple):
    rois: torch.Tensor          # (B, S, 4)
    labels: torch.Tensor        # (B, S) gt class or num_classes (bg)
    label_valid: torch.Tensor   # (B, S) the slot holds a real sample
    is_pos: torch.Tensor        # (B, S)
    reg_targets: torch.Tensor   # (B, S, 4)
    matched_gt: torch.Tensor    # (B, S) index of the matched gt (0 if none)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, D), idx (B, K) → (B, K, D)."""
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def sample_rois(proposals: torch.Tensor,
                prop_valid: torch.Tensor,
                gt_bboxes: torch.Tensor,
                gt_labels: torch.Tensor,
                gt_valid: torch.Tensor,
                num_classes: int,
                cfg: RoITrainConfig = RoITrainConfig(),
                priorities: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> SampledRoIs:
    """Assign and sample `cfg.num_samples` RoIs per image from the gt boxes
    and the proposals (B, P, 4). `priorities` (B, G + P) replace the
    sampler's draw from `generator`."""
    if cfg.sampler_type != 'random':
        raise NotImplementedError(f'sampler {cfg.sampler_type!r}: only the '
                                  'random sampler is ported')
    if cfg.add_gt_as_proposals:
        cands = torch.cat([gt_bboxes.to(proposals.dtype), proposals], dim=1)
        cand_valid = torch.cat([gt_valid, prop_valid], dim=1)
    else:
        cands, cand_valid = proposals, prop_valid
    assign = max_iou_assign(
        cands, gt_bboxes, gt_valid, gt_labels,
        pos_iou_thr=cfg.pos_iou_thr, neg_iou_thr=cfg.neg_iou_thr,
        min_pos_iou=cfg.min_pos_iou, match_low_quality=cfg.match_low_quality,
        prior_valid=cand_valid)
    agi = assign.assigned_gt_inds
    s = random_sample(agi, cfg.num_samples, cfg.pos_fraction,
                      priorities=priorities, generator=generator)
    rois = _gather_rows(cands, s.inds)
    matched = (torch.gather(agi, 1, s.inds) - 1).clamp(
        0, gt_bboxes.shape[1] - 1)
    labels = torch.where(s.is_pos, torch.gather(gt_labels.long(), 1, matched),
                         num_classes)
    reg_targets = bbox2delta(rois, _gather_rows(gt_bboxes, matched),
                             cfg.target_means, cfg.target_stds)
    return SampledRoIs(rois, labels, s.valid, s.is_pos, reg_targets, matched)


def bbox_loss(cls_scores: torch.Tensor,
              reg_preds: torch.Tensor,
              sampled: SampledRoIs,
              num_classes: int,
              cfg: RoITrainConfig = RoITrainConfig(),
              loss_weight_mask: Optional[torch.Tensor] = None
              ) -> Dict[str, torch.Tensor]:
    """Classification over the sampled RoIs and smooth-L1 over the
    positives, both averaged over the sampled count (the sigmoid
    classifier's also over its C + 1 columns). `loss_weight_mask` (B,)
    masks supervision to source images."""
    if cfg.reg_loss != 'l1':
        raise NotImplementedError(f'reg_loss {cfg.reg_loss!r}: only the '
                                  "smooth-L1 'l1' loss is ported")
    b, s = sampled.labels.shape
    w_img = torch.ones((b,), dtype=cls_scores.dtype,
                       device=cls_scores.device) \
        if loss_weight_mask is None else loss_weight_mask.to(cls_scores.dtype)
    w = sampled.label_valid.to(cls_scores.dtype) * w_img[:, None]
    if cfg.use_sigmoid_cls:
        cls_l = binary_cross_entropy(cls_scores, sampled.labels,
                                     weight=w[..., None], reduction='sum')
        cls_l = cls_l / torch.clamp(w.sum() * cls_scores.shape[-1], min=1.0)
    else:
        cls_l = cross_entropy(cls_scores, sampled.labels, weight=w,
                              reduction='sum')
        cls_l = cls_l / torch.clamp(w.sum(), min=1.0)

    if reg_preds.shape[-1] == 4:
        reg_sel = reg_preds
    else:
        reg_per_cls = reg_preds.reshape(b, s, num_classes, 4)
        lbl = sampled.labels.clamp(0, num_classes - 1)
        reg_sel = torch.gather(reg_per_cls, 2,
                               lbl[..., None, None].expand(b, s, 1, 4)
                               )[..., 0, :]
    pos_w = (sampled.is_pos & sampled.label_valid).to(reg_preds.dtype) * \
        w_img[:, None]
    reg_l = smooth_l1_loss(reg_sel, sampled.reg_targets,
                           weight=pos_w[..., None], reduction='sum')
    reg_l = reg_l / torch.clamp(w.sum(), min=1.0)
    return dict(loss_cls=cls_l, loss_bbox=reg_l)


def extract_roi_feats(feats: torch.Tensor, rois: torch.Tensor,
                      featmap_stride: int = 16, out_size: int = 7,
                      sampling_ratio: int = 2,
                      flatten: bool = False) -> torch.Tensor:
    """`SingleRoIExtractor` for the single-level DC5 trunk: feats
    (B, H, W, C) NHWC, rois (B, R, 4) → (B, R, o, o, C) or (B, R, o·o·C)
    x-major. On a card this launches the CUDA RoIAlign kernels (forward,
    and backward when the features need a gradient)."""
    return batched_roi_align(feats, rois, 1.0 / featmap_stride, out_size,
                             sampling_ratio, flatten=flatten)


def extract_roi_feats_fpn(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                          strides: Sequence[int] = (4, 8, 16, 32),
                          out_size: int = 7, sampling_ratio: int = 2,
                          finest_scale: int = 56,
                          flatten: bool = False) -> torch.Tensor:
    """The multi-level `SingleRoIExtractor`: feats are the pyramid's
    (B, H_l, W_l, C) NHWC levels, finest first (levels beyond `strides`
    are ignored); each RoI (B, R, 4) is pooled from level
    clamp(floor(log2(sqrt(area) / finest_scale))) → (B, R, o, o, C) or
    (B, R, o·o·C) x-major. On a card this launches the multi-level CUDA
    kernels (forward, and backward when a level needs a gradient)."""
    return batched_roi_align_fpn(feats, rois, strides, out_size,
                                 sampling_ratio, finest_scale=finest_scale,
                                 flatten=flatten)


def roi_head_predict(bbox_head_apply: Callable,
                     feats,
                     proposals: torch.Tensor,
                     prop_valid: torch.Tensor,
                     img_shape: torch.Tensor,
                     num_classes: int,
                     featmap_stride: int = 16,
                     reg_class_agnostic: bool = False,
                     target_stds: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2),
                     use_sigmoid_cls: bool = True,
                     cfg: RoITestConfig = RoITestConfig(),
                     roi_extractor: Optional[Callable] = None
                     ) -> Dict[str, torch.Tensor]:
    """RoIAlign → bbox head → decode → clip → `multiclass_nms`.

    `roi_extractor` (feats, rois) → roi_feats replaces the single-level
    extractor at `featmap_stride` (the FPN's multi-level one).

    A sigmoid head gets a synthesized zero background column; scores of
    padded proposals are zeroed by `prop_valid`; boxes are clipped to each
    image's (w, h, w, h). Returns dict(dets (B, max, 5), labels (B, max),
    valid (B, max)).
    """
    if roi_extractor is None:
        roi_feats = extract_roi_feats(feats, proposals, featmap_stride,
                                      flatten=True)
    else:
        roi_feats = roi_extractor(feats, proposals)
    cls, reg, _ = bbox_head_apply(roi_feats)
    cls = cls.float()
    reg = reg.float()
    if use_sigmoid_cls:
        probs = torch.sigmoid(cls)[..., :num_classes]
        scores = torch.cat([probs, torch.zeros_like(probs[..., :1])], dim=-1)
    else:
        scores = torch.softmax(cls, dim=-1)
    scores = scores * prop_valid[..., None]

    b, p = proposals.shape[:2]
    if reg_class_agnostic:
        dec = delta2bbox(proposals, reg.reshape(b, p, 4), stds=target_stds)
        boxes = dec[:, :, None, :].expand(b, p, num_classes, 4)
    else:
        boxes = delta2bbox(
            proposals[:, :, None, :].expand(b, p, num_classes, 4),
            reg.reshape(b, p, num_classes, 4), stds=target_stds)
    hw = img_shape.to(boxes.dtype)
    upper = torch.stack([hw[:, 1], hw[:, 0], hw[:, 1], hw[:, 0]],
                        dim=-1)[:, None, None, :]
    boxes = torch.minimum(torch.maximum(boxes, boxes.new_zeros(())), upper)

    dets, labels, valid = multiclass_nms(
        boxes.reshape(b, p, num_classes * 4), scores, cfg.score_thr,
        cfg.nms_iou_threshold, cfg.max_per_img, cfg.nms_tile, cfg.nms_pre,
        nms_type=cfg.nms_type)
    return dict(dets=dets, labels=labels, valid=valid)
