"""RPN head, its loss and proposal generation (counterpart of the JAX
package's `models/dense_heads/rpn_head.py`).

Outputs keep the JAX layout — cls (B, H, W, A), reg (B, H, W, A*4) — so the
flat anchor order is location-major, anchor-minor, as the anchors are.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ...core.anchors.anchor_generator import anchor_inside_flags
from ...core.bbox.assigners import max_iou_assign
from ...core.bbox.samplers import random_sample
from ...core.bbox.transforms import bbox2delta, clip_boxes, delta2bbox
from ...core.post.nms import NEG_INF, nms, topk_stable
from ...utils.registry import HEADS
from ..losses import binary_cross_entropy, smooth_l1_loss


@HEADS.register_module()
class RPNHead(nn.Module):
    """3x3 conv + ReLU + sibling 1x1 cls/reg convs. `in_channels` is the
    trunk's output width (flax infers it; torch needs it)."""

    def __init__(self, in_channels: int = 2048, feat_channels: int = 2048,
                 num_anchors: int = 15):
        super().__init__()
        self.rpn_conv = nn.Conv2d(in_channels, feat_channels, 3, padding=1)
        self.rpn_cls = nn.Conv2d(feat_channels, num_anchors, 1)
        self.rpn_reg = nn.Conv2d(feat_channels, num_anchors * 4, 1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, C, H, W) → cls (B, H, W, A), reg (B, H, W, A*4)."""
        t = torch.relu(self.rpn_conv(x))
        cls = self.rpn_cls(t).permute(0, 2, 3, 1)
        reg = self.rpn_reg(t).permute(0, 2, 3, 1)
        return cls, reg


class RPNTrainConfig(NamedTuple):
    """Assigner/sampler settings of the configs' `train_cfg.rpn`."""
    pos_iou_thr: float = 0.7
    neg_iou_thr: float = 0.3
    min_pos_iou: float = 0.3
    match_low_quality: bool = True
    num_samples: int = 256
    pos_fraction: float = 0.5
    allowed_border: int = 0
    target_means: Tuple[float, ...] = (0., 0., 0., 0.)
    target_stds: Tuple[float, ...] = (1., 1., 1., 1.)


def rpn_loss(cls_logits: torch.Tensor,
             reg_preds: torch.Tensor,
             anchors: torch.Tensor,
             gt_bboxes: torch.Tensor,
             gt_valid: torch.Tensor,
             img_shape: torch.Tensor,
             cfg: RPNTrainConfig = RPNTrainConfig(),
             loss_weight_mask: Optional[torch.Tensor] = None,
             priorities: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
    """Batched RPN loss: assign anchors inside each image, sample
    `num_samples`, BCE on the sampled anchors and smooth-L1 on the
    positives, both summed per image and averaged over the sampled count.

    Args:
        cls_logits: (B, H, W, A); reg_preds: (B, H, W, A*4).
        anchors: (N, 4), N = H*W*A, location-major as the reshape.
        gt_*: padded gt blocks; img_shape: (B, 2) valid (h, w).
        loss_weight_mask: (B,) per-image weight, `domain == 0` for DA.
        priorities: (B, N) sampler priorities, else drawn from `generator`.

    Returns dict(loss_rpn_cls, loss_rpn_bbox).
    """
    b = cls_logits.shape[0]
    n = anchors.shape[0]
    cls_flat = cls_logits.reshape(b, n)
    reg_flat = reg_preds.reshape(b, n, 4)
    inside = anchor_inside_flags(anchors, img_shape[:, None, :],
                                 cfg.allowed_border)
    assign = max_iou_assign(
        anchors, gt_bboxes, gt_valid, None,
        pos_iou_thr=cfg.pos_iou_thr, neg_iou_thr=cfg.neg_iou_thr,
        min_pos_iou=cfg.min_pos_iou, match_low_quality=cfg.match_low_quality,
        prior_valid=inside)
    sample = random_sample(assign.assigned_gt_inds, cfg.num_samples,
                           cfg.pos_fraction, priorities=priorities,
                           generator=generator)
    pos, neg = sample.pos_mask, sample.neg_mask
    chosen = pos | neg
    # single-logit sigmoid head: target 1 on positives, 0 on negatives
    cls_l = binary_cross_entropy(cls_flat, pos.to(cls_flat.dtype),
                                 weight=chosen.to(cls_flat.dtype),
                                 reduction='none').sum(-1)
    g = gt_bboxes.shape[1]
    matched = (assign.assigned_gt_inds - 1).clamp(0, g - 1)
    matched_gt = torch.gather(gt_bboxes, 1,
                              matched[..., None].expand(b, n, 4))
    targets = bbox2delta(anchors, matched_gt, cfg.target_means,
                         cfg.target_stds)
    reg_l = smooth_l1_loss(reg_flat, targets,
                           weight=pos[..., None].to(reg_flat.dtype),
                           beta=1.0, reduction='none').sum((-2, -1))
    counts = chosen.sum(-1)
    w = torch.ones((b,), dtype=cls_l.dtype, device=cls_l.device) \
        if loss_weight_mask is None else loss_weight_mask.to(cls_l.dtype)
    avg = torch.clamp((counts * w).sum(), min=1.0)
    return dict(loss_rpn_cls=(cls_l * w).sum() / avg,
                loss_rpn_bbox=(reg_l * w).sum() / avg)


class ProposalConfig(NamedTuple):
    """nms_pre/max_per_img per the config's `rpn_proposal`/`test_cfg.rpn`."""
    nms_pre: int = 4096
    max_per_img: int = 2000
    nms_iou_threshold: float = 0.7
    min_bbox_size: float = 0.0
    nms_tile: int = 512


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, D), idx (B, K) → (B, K, D)."""
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def rpn_proposals(cls_logits: torch.Tensor,
                  reg_preds: torch.Tensor,
                  anchors: torch.Tensor,
                  img_shape: torch.Tensor,
                  cfg: ProposalConfig = ProposalConfig()
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched proposals: top-`nms_pre` by logit → decode → clip →
    min-size filter → NMS → top-`max_per_img`, scores as sigmoid.

    Returns (proposals (B, P, 4), scores (B, P), valid (B, P)), zero-padded.
    """
    b = cls_logits.shape[0]
    n = anchors.shape[0]
    cls_flat = cls_logits.reshape(b, n).float()
    reg_flat = reg_preds.reshape(b, n, 4).float()

    k = min(cfg.nms_pre, n)
    scores, idx = topk_stable(cls_flat, k)
    boxes = delta2bbox(anchors[idx], _take(reg_flat, idx))
    boxes = clip_boxes(boxes, img_shape[:, None, :].to(boxes.dtype))
    if cfg.min_bbox_size >= 0:
        w = boxes[..., 2] - boxes[..., 0]
        h = boxes[..., 3] - boxes[..., 1]
        ok = (w > cfg.min_bbox_size) & (h > cfg.min_bbox_size)
        scores = torch.where(ok, scores, scores.new_tensor(NEG_INF))
    keep, _ = nms(boxes, scores, cfg.nms_iou_threshold, cfg.nms_tile)
    kept_scores = torch.where(keep, scores, scores.new_tensor(NEG_INF))
    p = min(cfg.max_per_img, k)
    top_scores, top_idx = topk_stable(kept_scores, p)
    valid = top_scores > NEG_INF / 2
    out_boxes = _take(boxes, top_idx) * valid[..., None]
    out_scores = torch.where(valid, torch.sigmoid(top_scores),
                             top_scores.new_zeros(()))
    return out_boxes, out_scores, valid
