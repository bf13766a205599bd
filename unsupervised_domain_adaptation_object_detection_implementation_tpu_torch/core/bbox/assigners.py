"""Dense max-IoU assignment (torch counterpart of the JAX package's
`core/bbox/assigners.py`).

Padded gt blocks with a validity mask; the per-gt low-quality matching loop
of mmdet is a dense claims matrix reduced along the gt axis, where a later
gt wins a prior that two gts both claim. Leading batch dims are taken as
they come (the JAX function is vmapped over them).

Encoding (mmdet): -1 = ignored, 0 = negative, g + 1 = assigned to gt g.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .iou import bbox_overlaps


class AssignResult(NamedTuple):
    assigned_gt_inds: torch.Tensor   # (..., N) int64 in {-1, 0, 1..G}
    max_overlaps: torch.Tensor       # (..., N)
    labels: torch.Tensor             # (..., N) class of the matched gt or -1


def max_iou_assign(priors: torch.Tensor,
                   gt_bboxes: torch.Tensor,
                   gt_valid: torch.Tensor,
                   gt_labels: Optional[torch.Tensor] = None,
                   pos_iou_thr: float = 0.7,
                   neg_iou_thr: float = 0.3,
                   min_pos_iou: float = 0.3,
                   match_low_quality: bool = True,
                   prior_valid: Optional[torch.Tensor] = None
                   ) -> AssignResult:
    """Assign each prior (..., N, 4) to a gt (..., G, 4) / background /
    ignore. `gt_valid` (..., G) masks padded gts; priors where
    `prior_valid` (..., N) is False stay at -1."""
    n = priors.shape[-2]
    g = gt_bboxes.shape[-2]
    ious = bbox_overlaps(gt_bboxes, priors)                  # (..., G, N)
    ious = torch.where(gt_valid[..., :, None], ious, ious.new_zeros(()))
    any_gt = gt_valid.any(dim=-1, keepdim=True)               # (..., 1)
    max_overlaps = ious.amax(dim=-2)                          # (..., N)
    argmax_overlaps = torch.argmax(ious, dim=-2)              # first max

    assigned = torch.full(max_overlaps.shape, -1, dtype=torch.int64,
                          device=priors.device)
    assigned = torch.where(max_overlaps < neg_iou_thr,
                           torch.zeros_like(assigned), assigned)
    assigned = torch.where(max_overlaps >= pos_iou_thr, argmax_overlaps + 1,
                           assigned)
    if match_low_quality:
        gt_best = ious.amax(dim=-1, keepdim=True)             # (..., G, 1)
        claims = (ious == gt_best) & (gt_best >= min_pos_iou) & \
            gt_valid[..., :, None] & (gt_best > 0)
        g_idx = torch.arange(1, g + 1, device=priors.device)[:, None]
        last_claim = torch.where(claims, g_idx, 0).amax(dim=-2)
        assigned = torch.where(last_claim > 0, last_claim, assigned)

    # no gt at all: everything that is not ignored is background
    assigned = torch.where(any_gt, assigned, torch.where(
        assigned == -1, assigned, torch.zeros_like(assigned)))
    if prior_valid is not None:
        assigned = torch.where(prior_valid, assigned,
                               torch.full_like(assigned, -1))
    if gt_labels is not None:
        matched = (assigned - 1).clamp(0, g - 1)
        picked = torch.gather(gt_labels.long().expand(
            *matched.shape[:-1], g), -1, matched)
        labels = torch.where(assigned > 0, picked,
                             torch.full_like(picked, -1))
    else:
        labels = torch.full_like(assigned, -1)
    return AssignResult(assigned, max_overlaps, labels)
