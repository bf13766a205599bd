"""RPN head and proposal generation (counterpart of the JAX package's
`models/dense_heads/rpn_head.py`, inference part).

Outputs keep the JAX layout — cls (B, H, W, A), reg (B, H, W, A*4) — so the
flat anchor order is location-major, anchor-minor, as the anchors are.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch import nn

from ...core.bbox.transforms import clip_boxes, delta2bbox
from ...core.post.nms import NEG_INF, nms, topk_stable
from ...utils.registry import HEADS


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
