"""Adaptive training sample selection (counterpart of the JAX package's
`core/bbox/atss_assigner.py:atss_assign`).

Per gt, the anchors of each level whose centre lies at or within the k-th
smallest centre distance of that level are candidates (at equal distances
a level can admit more than k); the IoU threshold is the mean plus the
standard deviation of the candidates' IoUs, both over the candidate count;
positives also need their centre strictly inside the gt; an anchor that
several gts claim goes to the first gt of highest IoU. The JAX package's
form, not mmdet's (whose per-level top-k admits exactly k and whose std
divides by k - 1). Leading batch dims of the gts are taken as they come
(the JAX function is vmapped over images); the anchors are shared.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .assigners import AssignResult
from .iou import bbox_overlaps


def atss_assign(anchors: torch.Tensor,
                num_level_anchors: Sequence[int],
                gt_bboxes: torch.Tensor,
                gt_valid: torch.Tensor,
                gt_labels: Optional[torch.Tensor] = None,
                topk: int = 9) -> AssignResult:
    """anchors (N, 4) in level order (`num_level_anchors` the levels'
    sizes), gt_bboxes (..., G, 4), gt_valid (..., G) → the assignment of
    each anchor, (..., N), in `max_iou_assign`'s encoding."""
    g = gt_bboxes.shape[-2]
    ious = bbox_overlaps(gt_bboxes, anchors)                  # (..., G, N)
    ious = torch.where(gt_valid[..., None], ious, ious.new_zeros(()))
    ax = (anchors[:, 0] + anchors[:, 2]) * 0.5
    ay = (anchors[:, 1] + anchors[:, 3]) * 0.5
    gx = (gt_bboxes[..., 0] + gt_bboxes[..., 2]) * 0.5
    gy = (gt_bboxes[..., 1] + gt_bboxes[..., 3]) * 0.5
    dx = ax - gx[..., None]
    dy = ay - gy[..., None]
    # f32 sqrt of the summed squares, as the JAX package computes it:
    # symmetric anchor grids tie exactly, and the `<=` keeps every tie
    dist = torch.sqrt(dx * dx + dy * dy)                      # (..., G, N)

    cand, start = [], 0
    for n_l in num_level_anchors:
        d_l = dist[..., start:start + n_l]
        k = min(topk, n_l)
        thresh = torch.kthvalue(d_l, k, dim=-1, keepdim=True).values
        cand.append(d_l <= thresh)
        start += n_l
    cand = torch.cat(cand, dim=-1)

    cnt = cand.sum(-1).clamp(min=1)
    mean = (ious * cand).sum(-1) / cnt
    var = ((ious - mean[..., None]) ** 2 * cand).sum(-1) / cnt
    thr = mean + torch.sqrt(var)                              # (..., G)

    inside = ((ax > gt_bboxes[..., 0:1]) & (ax < gt_bboxes[..., 2:3]) &
              (ay > gt_bboxes[..., 1:2]) & (ay < gt_bboxes[..., 3:4]))
    pos = cand & (ious >= thr[..., None]) & inside & gt_valid[..., None]

    claimed = pos.any(dim=-2)
    best_gt = torch.argmax(torch.where(pos, ious, ious.new_tensor(-1.0)),
                           dim=-2)                            # first max
    assigned = torch.where(claimed, best_gt + 1, torch.zeros_like(best_gt))
    max_overlaps = torch.where(pos, ious, ious.new_zeros(())).amax(dim=-2)
    if gt_labels is not None:
        matched = (assigned - 1).clamp(0, g - 1)
        picked = torch.gather(gt_labels.long(), -1, matched)
        labels = torch.where(assigned > 0, picked, torch.full_like(picked, -1))
    else:
        labels = torch.full_like(assigned, -1)
    return AssignResult(assigned, max_overlaps, labels)
