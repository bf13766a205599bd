"""Box IoU/IoF (torch counterpart of the JAX package's `core/bbox/iou.py`).

Batched over arbitrary leading dims, static shapes, same arithmetic order as
the reference so threshold comparisons (`iou > thr` in NMS) agree.
"""

from __future__ import annotations

import torch


def bbox_area(boxes: torch.Tensor, offset: float = 0.0) -> torch.Tensor:
    """Area of [..., 4] xyxy boxes. `offset=1` gives VOC-legacy areas."""
    w = (boxes[..., 2] - boxes[..., 0] + offset).clamp(min=0.0)
    h = (boxes[..., 3] - boxes[..., 1] + offset).clamp(min=0.0)
    return w * h


def bbox_overlaps(boxes1: torch.Tensor,
                  boxes2: torch.Tensor,
                  mode: str = 'iou',
                  offset: float = 0.0,
                  eps: float = 1e-6) -> torch.Tensor:
    """Pairwise overlaps between [..., N, 4] and [..., M, 4] xyxy boxes.

    Returns [..., N, M]: intersection over union (`'iou'`) or over the area
    of boxes1 (`'iof'`).
    """
    if mode not in ('iou', 'iof'):
        raise ValueError(f'mode must be iou or iof, got {mode!r}')
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt + offset).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area1 = bbox_area(boxes1, offset)[..., :, None]
    if mode == 'iou':
        area2 = bbox_area(boxes2, offset)[..., None, :]
        union = area1 + area2 - inter
    else:
        union = area1
    return inter / union.clamp(min=eps)
