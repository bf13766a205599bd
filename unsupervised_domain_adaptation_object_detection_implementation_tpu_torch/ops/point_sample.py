"""Point sampling (counterpart of the JAX package's `ops/point_sample.py`:
mmcv's `point_sample` and `rel_roi_point_to_rel_img_point`, which
PointRend's head reads its features with).

`point_sample` is `F.grid_sample(align_corners=False)` at scattered
points: normalized [0, 1] (x, y) map to pixel space as `p * size - 0.5`
(or `p * (size - 1)` with `align_corners`), bilinear over four taps, zero
outside the map. NHWC, in the feature dtype promoted to at least f32, the
taps summed in the JAX order. Plain torch on every device: the JAX package
runs it in XLA, not Pallas, and autograd gives both the features' and (not
used by PointRend) the points' gradients.
"""

from __future__ import annotations

from typing import Sequence

import torch


def point_sample(feat: torch.Tensor, points: torch.Tensor,
                 align_corners: bool = False) -> torch.Tensor:
    """Sample (H, W, C) at (P, 2) normalized (x, y) → (P, C)."""
    return batched_point_sample(feat[None], points[None], align_corners)[0]


def batched_point_sample(feats: torch.Tensor, points: torch.Tensor,
                         align_corners: bool = False) -> torch.Tensor:
    """feats (B, H, W, C), points (B, P, 2) → (B, P, C)."""
    b, h, w, c = feats.shape
    if align_corners:
        xs = points[..., 0] * (w - 1)
        ys = points[..., 1] * (h - 1)
    else:
        xs = points[..., 0] * w - 0.5
        ys = points[..., 1] * h - 0.5
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy1 = ys - y0
    wx1 = xs - x0
    flat = feats.reshape(b, h * w, c)
    y0i = y0.long()
    x0i = x0.long()

    def tap(yi, xi, wgt):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        vals = torch.gather(flat, 1, idx[..., None].expand(*idx.shape, c))
        return vals * (wgt * inside)[..., None]

    return (tap(y0i, x0i, (1 - wy1) * (1 - wx1))
            + tap(y0i, x0i + 1, (1 - wy1) * wx1)
            + tap(y0i + 1, x0i, wy1 * (1 - wx1))
            + tap(y0i + 1, x0i + 1, wy1 * wx1))


def rel_roi_point_to_rel_img_point(rois: torch.Tensor,
                                   rel_roi_points: torch.Tensor,
                                   img_shape: Sequence[int],
                                   spatial_scale: float = 1.0
                                   ) -> torch.Tensor:
    """Map (P, 2) points relative to each of the (R, 4) xyxy RoIs into the
    normalized coordinates of an (H, W) map → (R, P, 2) for
    `point_sample`."""
    h, w = img_shape
    roi_w = rois[:, 2] - rois[:, 0]
    roi_h = rois[:, 3] - rois[:, 1]
    x = rois[:, 0:1] + rel_roi_points[None, :, 0] * roi_w[:, None]
    y = rois[:, 1:2] + rel_roi_points[None, :, 1] * roi_h[:, None]
    return torch.stack([x * spatial_scale / w, y * spatial_scale / h], -1)
