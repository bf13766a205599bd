"""The bucketing box coder of SABL (counterpart of the JAX package's
`core/bbox/extra_coders.py`: `bbox_rescale`, `bbox2bucket`,
`bucket2bbox`; reference `mmdet/core/bbox/coder/bucketing_bbox_coder.py`).

Every function takes any leading dims (the JAX package's take one row
dim). Each side of a box gets `ceil(num_buckets / 2)` buckets, laid out
[l | r | t | d], each side's buckets counted from the outside in. The
top-2 choices among buckets go through `topk_stable`, so buckets at the
same distance (mirrored sides of a centred gt) are chosen in `lax.top_k`'s
order, the lower index first.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..post.nms import topk_stable


def bbox_rescale(bboxes: torch.Tensor, scale_factor: float) -> torch.Tensor:
    """(..., 4) xyxy boxes scaled about their centres by `scale_factor`."""
    cx = (bboxes[..., 0] + bboxes[..., 2]) * 0.5
    cy = (bboxes[..., 1] + bboxes[..., 3]) * 0.5
    w = (bboxes[..., 2] - bboxes[..., 0]) * scale_factor
    h = (bboxes[..., 3] - bboxes[..., 1]) * scale_factor
    return torch.stack([cx - w * 0.5, cy - h * 0.5,
                        cx + w * 0.5, cy + h * 0.5], dim=-1)


def side_num_of(num_buckets: int) -> int:
    return int(math.ceil(num_buckets / 2.0))


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _side_buckets(proposals: torch.Tensor, num_buckets: int,
                  scale_factor: float):
    """The bucket width and height (...,) and the four sides' bucket
    centres (..., side_num) of the rescaled proposals. Their width and
    height are clamped to 1e-4: a degenerate (padded) proposal would
    otherwise divide by zero and poison masked loss terms (nan · 0)."""
    p = bbox_rescale(proposals, scale_factor)
    pw = (p[..., 2] - p[..., 0]).clamp(min=1e-4)
    ph = (p[..., 3] - p[..., 1]).clamp(min=1e-4)
    bucket_w = pw / num_buckets
    bucket_h = ph / num_buckets
    steps = 0.5 + torch.arange(side_num_of(num_buckets), dtype=p.dtype,
                               device=p.device)
    l = p[..., 0:1] + steps * bucket_w[..., None]
    r = p[..., 2:3] - steps * bucket_w[..., None]
    t = p[..., 1:2] + steps * bucket_h[..., None]
    d = p[..., 3:4] - steps * bucket_h[..., None]
    return bucket_w, bucket_h, l, r, t, d


def bbox2bucket(proposals: torch.Tensor,
                gt: torch.Tensor,
                num_buckets: int,
                scale_factor: float,
                offset_topk: int = 2,
                offset_upperbound: float = 1.0,
                cls_ignore_neighbor: bool = True):
    """SABL's targets of `gt` (..., 4) on `proposals` (..., 4) (broadcast
    against each other) → (offsets, offset weights, bucket labels,
    classification weights), each (..., 4 · side_num) laid out
    [l | r | t | d]: each side's offsets from its bucket centres in
    bucket units; the nearest bucket's and, within `offset_upperbound`,
    the second's offsets weighted; the nearest bucket the label; the
    buckets within one unit of the edge other than it unweighted in the
    classification."""
    side_num = side_num_of(num_buckets)
    bucket_w, bucket_h, l_b, r_b, t_b, d_b = _side_buckets(
        proposals, num_buckets, scale_factor)
    offs = [(l_b - gt[..., 0:1]) / bucket_w[..., None],
            (r_b - gt[..., 2:3]) / bucket_w[..., None],
            (t_b - gt[..., 1:2]) / bucket_h[..., None],
            (d_b - gt[..., 3:4]) / bucket_h[..., None]]
    weights, labels, cls_w = [], [], []
    for o in offs:
        vals, idx = topk_stable(-o.abs(), offset_topk)
        vals = -vals                                    # ascending distances
        w = torch.zeros_like(o)
        for k in range(offset_topk):
            hot = _one_hot(idx[..., k], side_num, o.dtype)
            w = w + (hot if k == 0 else
                     hot * (vals[..., k] < offset_upperbound).to(o.dtype)
                     [..., None])
        weights.append(w.clamp(max=1.0))
        labels.append(_one_hot(idx[..., 0], side_num, o.dtype))
        cls_w.append((o.abs() < 1).to(o.dtype))
    offsets = torch.cat(offs, dim=-1)
    offset_weights = torch.cat(weights, dim=-1)
    bucket_labels = torch.cat(labels, dim=-1)
    cls_weights = torch.cat(cls_w, dim=-1)
    if cls_ignore_neighbor:
        cls_weights = (~((cls_weights == 1) & (bucket_labels == 0))).to(
            offsets.dtype)
    else:
        cls_weights = torch.ones_like(cls_weights)
    return offsets, offset_weights, bucket_labels, cls_weights


def bucket2bbox(proposals: torch.Tensor,
                cls_preds: torch.Tensor,
                offset_preds: torch.Tensor,
                num_buckets: int,
                scale_factor: float = 1.0,
                max_shape: Optional[Tuple[int, int]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SABL's decode of (..., 4 · side_num) bucket logits and offsets on
    `proposals` (..., 4) → (boxes (..., 4), localisation confidence
    (...,)): each side at its most likely bucket's centre less that
    bucket's offset; the confidence the mean over the sides of the top
    bucket's probability, plus the runner-up's where the two are
    neighbours."""
    side_num = side_num_of(num_buckets)
    lead = proposals.shape[:-1]
    scores = torch.softmax(cls_preds.reshape(*lead, 4, side_num), dim=-1)
    top2, lab2 = topk_stable(scores, 2)                 # (..., 4, 2)
    best = lab2[..., 0]                                 # (..., 4)
    bucket_w, bucket_h, _, _, _, _ = _side_buckets(proposals, num_buckets,
                                                   scale_factor)
    p = bbox_rescale(proposals, scale_factor)
    steps = 0.5 + best.to(p.dtype)
    l_buckets = p[..., 0] + steps[..., 0] * bucket_w
    r_buckets = p[..., 2] - steps[..., 1] * bucket_w
    t_buckets = p[..., 1] + steps[..., 2] * bucket_h
    d_buckets = p[..., 3] - steps[..., 3] * bucket_h
    off = offset_preds.reshape(*lead, 4, side_num)
    sel = torch.gather(off, -1, best[..., None])[..., 0]   # (..., 4)
    x1 = l_buckets - sel[..., 0] * bucket_w
    x2 = r_buckets - sel[..., 1] * bucket_w
    y1 = t_buckets - sel[..., 2] * bucket_h
    y2 = d_buckets - sel[..., 3] * bucket_h
    if max_shape is not None:
        x1 = x1.clamp(0, max_shape[1] - 1)
        x2 = x2.clamp(0, max_shape[1] - 1)
        y1 = y1.clamp(0, max_shape[0] - 1)
        y2 = y2.clamp(0, max_shape[0] - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    neighbor = (lab2[..., 0] - lab2[..., 1]).abs() == 1
    conf = top2[..., 0] + top2[..., 1] * neighbor.to(top2.dtype)
    return boxes, conf.mean(dim=-1)
