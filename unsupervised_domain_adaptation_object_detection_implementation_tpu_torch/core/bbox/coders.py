"""Point-distance box coding (counterpart of the JAX package's
`core/bbox/coders.py`): `distance2bbox` / `bbox2distance`, the
DistancePointBBoxCoder of FCOS, ATSS and GFL, and `bbox2tblr` /
`tblr2bbox`, the TBLRBBoxCoder of FSAF."""

from __future__ import annotations

from typing import Optional, Tuple

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


def _centers(priors: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return ((priors[..., 0] + priors[..., 2]) * 0.5,
            (priors[..., 1] + priors[..., 3]) * 0.5)


def bbox2tblr(priors: torch.Tensor, gts: torch.Tensor,
              normalizer: float = 4.0, normalize_by_wh: bool = True
              ) -> torch.Tensor:
    """(..., 4) gt boxes as (top, bottom, left, right) distances from the
    (..., 4) priors' centres over `normalizer`; with `normalize_by_wh`
    over the prior's (h, h, w, w) as well (clamped to 1e-6), in the JAX
    package's order of operations."""
    px, py = _centers(priors)
    tblr = torch.stack([py - gts[..., 1], gts[..., 3] - py,
                        px - gts[..., 0], gts[..., 2] - px], dim=-1)
    if not normalize_by_wh:
        return tblr / normalizer
    w = (priors[..., 2] - priors[..., 0])[..., None]
    h = (priors[..., 3] - priors[..., 1])[..., None]
    wh = torch.cat([h, h, w, w], dim=-1)
    return tblr / wh.clamp(min=1e-6) / normalizer


def tblr2bbox(priors: torch.Tensor, tblr: torch.Tensor,
              normalizer: float = 4.0, normalize_by_wh: bool = True,
              max_shape: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., 4) (top, bottom, left, right) distances from the priors'
    centres (x `normalizer`, and x the prior's (h, h, w, w) with
    `normalize_by_wh`) → (..., 4) xyxy boxes, clipped to `max_shape` (h, w)
    when given."""
    px, py = _centers(priors)
    d = tblr * normalizer
    if normalize_by_wh:
        w = priors[..., 2] - priors[..., 0]
        h = priors[..., 3] - priors[..., 1]
        d = d * torch.stack([h, h, w, w], dim=-1)
    boxes = torch.stack([px - d[..., 2], py - d[..., 0],
                         px + d[..., 3], py + d[..., 1]], dim=-1)
    return boxes if max_shape is None else clip_boxes(boxes, max_shape)
