"""Assigners beyond max-IoU (counterpart of the JAX package's
`core/bbox/extra_assigners.py`; only `center_region_assign`, which the
Cascade RPN's first stage uses, is ported).

Dense over a padded (..., G, N) gt-by-prior matrix, leading batch dims
taken as they come (the JAX function is vmapped over them).
"""

from __future__ import annotations

from typing import Optional

import torch

from .assigners import AssignResult
from .iou import bbox_overlaps


def _labels_for(assigned: torch.Tensor, gt_labels: Optional[torch.Tensor],
                num_gt: int) -> torch.Tensor:
    """The class of each prior's gt, -1 where it has none."""
    if gt_labels is None:
        return torch.full_like(assigned, -1)
    matched = (assigned - 1).clamp(0, num_gt - 1)
    picked = torch.gather(gt_labels.long().expand(
        *matched.shape[:-1], num_gt), -1, matched)
    return torch.where(assigned > 0, picked, torch.full_like(picked, -1))


def center_region_assign(bboxes: torch.Tensor,
                         gt_bboxes: torch.Tensor,
                         gt_valid: torch.Tensor,
                         gt_labels: Optional[torch.Tensor] = None,
                         pos_scale: float = 0.2,
                         neg_scale: float = 0.2,
                         min_pos_iof: float = 1e-2) -> AssignResult:
    """FSAF's effective / ignore regions: a prior (..., N, 4), read by its
    center, is positive for a gt (..., G, 4) whose core (the box scaled by
    `pos_scale` about its center) holds that center, ignored (-1) inside a
    shadow region (`neg_scale`) and negative elsewhere. Where several gts
    claim a prior the smallest in area wins, the first of equal ones;
    `max_overlaps` is the largest IoF of a valid gt over the prior."""
    g = gt_bboxes.shape[-2]
    cx = (bboxes[..., 0] + bboxes[..., 2]) / 2
    cy = (bboxes[..., 1] + bboxes[..., 3]) / 2
    cx, cy = cx[..., None, :], cy[..., None, :]

    def inside(s):                                           # (..., G, N)
        ctr = (gt_bboxes[..., :2] + gt_bboxes[..., 2:]) / 2
        half = (gt_bboxes[..., 2:] - gt_bboxes[..., :2]) / 2 * s
        lo, hi = ctr - half, ctr + half
        return ((cx >= lo[..., 0:1]) & (cx <= hi[..., 0:1])
                & (cy >= lo[..., 1:2]) & (cy <= hi[..., 1:2])
                & gt_valid[..., :, None])

    in_core = inside(pos_scale)
    in_shadow = inside(neg_scale)
    area = (gt_bboxes[..., 2] - gt_bboxes[..., 0]) * \
        (gt_bboxes[..., 3] - gt_bboxes[..., 1])
    inf = area.new_tensor(float('inf'))
    area = torch.where(gt_valid, area, inf)
    key = torch.where(in_core, area[..., :, None], inf)     # (..., G, N)
    best_gt = torch.argmin(key, dim=-2)
    is_pos = in_core.any(dim=-2)
    is_ign = in_shadow.any(dim=-2) & ~is_pos
    assigned = torch.where(is_pos, best_gt + 1, torch.where(
        is_ign, torch.full_like(best_gt, -1), torch.zeros_like(best_gt)))
    labels = _labels_for(assigned, gt_labels, g)
    n = bboxes.shape[-2]
    iof = bbox_overlaps(gt_bboxes, bboxes, mode='iof') if min_pos_iof > 0 \
        else gt_bboxes.new_zeros(gt_bboxes.shape[:-1] + (n,))
    max_overlaps = torch.where(gt_valid[..., :, None], iof,
                               iof.new_zeros(())).amax(dim=-2)
    return AssignResult(assigned, max_overlaps, labels)
