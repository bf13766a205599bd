"""Box transforms: delta coding, clipping, result packing (torch counterpart
of the JAX package's `core/bbox/transforms.py`)."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch


def delta2bbox(rois: torch.Tensor,
               deltas: torch.Tensor,
               means: Sequence[float] = (0., 0., 0., 0.),
               stds: Sequence[float] = (1., 1., 1., 1.),
               max_shape: Optional[torch.Tensor] = None,
               wh_ratio_clip: float = 16 / 1000) -> torch.Tensor:
    """Decode [..., 4] deltas w.r.t. [..., 4] xyxy rois
    (DeltaXYWHBBoxCoder.decode): dxy scaled by wh, dwh exponentiated after
    the `wh_ratio_clip` clamp, optional clip to `max_shape` ([..., 2] as
    (h, w))."""
    means = deltas.new_tensor(means)
    stds = deltas.new_tensor(stds)
    denorm = deltas * stds + means
    dx, dy, dw, dh = denorm.unbind(-1)
    max_ratio = abs(math.log(wh_ratio_clip))
    dw = dw.clamp(-max_ratio, max_ratio)
    dh = dh.clamp(-max_ratio, max_ratio)

    px = (rois[..., 0] + rois[..., 2]) * 0.5
    py = (rois[..., 1] + rois[..., 3]) * 0.5
    pw = rois[..., 2] - rois[..., 0]
    ph = rois[..., 3] - rois[..., 1]

    gx = px + pw * dx
    gy = py + ph * dy
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)

    boxes = torch.stack([gx - gw * 0.5, gy - gh * 0.5,
                         gx + gw * 0.5, gy + gh * 0.5], dim=-1)
    if max_shape is not None:
        boxes = clip_boxes(boxes, max_shape)
    return boxes


def bbox2delta(proposals: torch.Tensor,
               gt: torch.Tensor,
               means: Sequence[float] = (0., 0., 0., 0.),
               stds: Sequence[float] = (1., 1., 1., 1.),
               eps: float = 1e-6) -> torch.Tensor:
    """Encode gt boxes as deltas w.r.t. proposals (DeltaXYWHBBoxCoder.encode)."""
    px = (proposals[..., 0] + proposals[..., 2]) * 0.5
    py = (proposals[..., 1] + proposals[..., 3]) * 0.5
    pw = (proposals[..., 2] - proposals[..., 0]).clamp(min=eps)
    ph = (proposals[..., 3] - proposals[..., 1]).clamp(min=eps)

    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    gw = (gt[..., 2] - gt[..., 0]).clamp(min=eps)
    gh = (gt[..., 3] - gt[..., 1]).clamp(min=eps)

    deltas = torch.stack([(gx - px) / pw, (gy - py) / ph,
                          torch.log(gw / pw), torch.log(gh / ph)], dim=-1)
    return (deltas - deltas.new_tensor(means)) / deltas.new_tensor(stds)


def clip_boxes(boxes: torch.Tensor, img_shape: torch.Tensor) -> torch.Tensor:
    """Clip [..., 4] xyxy boxes to (h, w).

    `img_shape` is [..., 2] (h, w), broadcastable against boxes' batch dims
    (per-image valid shapes, not the padded canvas).
    """
    img_shape = torch.as_tensor(img_shape, device=boxes.device).to(boxes.dtype)
    h = img_shape[..., 0]
    w = img_shape[..., 1]
    zero = boxes.new_zeros(())
    x1 = torch.minimum(torch.maximum(boxes[..., 0], zero), w)
    y1 = torch.minimum(torch.maximum(boxes[..., 1], zero), h)
    x2 = torch.minimum(torch.maximum(boxes[..., 2], zero), w)
    y2 = torch.minimum(torch.maximum(boxes[..., 3], zero), h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def bbox2result(bboxes: np.ndarray, labels: np.ndarray, scores: np.ndarray,
                valid: np.ndarray, num_classes: int):
    """Padded outputs → `list[num_classes]` of (n, 5) [x1,y1,x2,y2,score]
    float32 arrays, the reference's per-class result format."""
    bboxes = np.asarray(bboxes)
    labels = np.asarray(labels)
    scores = np.asarray(scores)
    valid = np.asarray(valid).astype(bool)
    out = []
    for c in range(num_classes):
        sel = valid & (labels == c)
        det = np.concatenate([bboxes[sel], scores[sel, None]], axis=1)
        out.append(det.astype(np.float32))
    return out
