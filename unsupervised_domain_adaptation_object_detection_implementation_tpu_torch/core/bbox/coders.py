"""Point-distance box coding (counterpart of the JAX package's
`core/bbox/coders.py`: `distance2bbox`, `bbox2distance`, the
DistancePointBBoxCoder of FCOS, ATSS and GFL). The TBLR pair of FSAF is
not ported yet."""

from __future__ import annotations

from typing import Optional

import torch

from .transforms import clip_boxes


def distance2bbox(points: torch.Tensor, distances: torch.Tensor,
                  max_shape: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., 2) (x, y) points and (..., 4) (l, t, r, b) distances → (..., 4)
    xyxy boxes, clipped to `max_shape` (..., 2) (h, w) when given."""
    boxes = torch.stack([points[..., 0] - distances[..., 0],
                         points[..., 1] - distances[..., 1],
                         points[..., 0] + distances[..., 2],
                         points[..., 1] + distances[..., 3]], dim=-1)
    return boxes if max_shape is None else clip_boxes(boxes, max_shape)


def bbox2distance(points: torch.Tensor, boxes: torch.Tensor,
                  max_dist: Optional[float] = None, eps: float = 0.1
                  ) -> torch.Tensor:
    """(..., 2) points and (..., 4) xyxy boxes → (..., 4) (l, t, r, b),
    clipped to [0, max_dist - eps] when `max_dist` is given."""
    out = torch.stack([points[..., 0] - boxes[..., 0],
                       points[..., 1] - boxes[..., 1],
                       boxes[..., 2] - points[..., 0],
                       boxes[..., 3] - points[..., 1]], dim=-1)
    if max_dist is not None:
        out = out.clamp(0, max_dist - eps)
    return out
