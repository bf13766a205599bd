"""FoveaBox (counterpart of the JAX package's `models/detectors/fovea.py`;
reference `mmdet/models/dense_heads/fovea_head.py`).

A location is positive for the smallest gt whose fovea (its centre
`sigma` of the box) holds it and whose sqrt(area) lies in the level's
scale range, inclusive at both ends; the ranges overlap, so a gt may train
on two adjacent levels. The regression is the log of the location's
distances to the gt's corners over the level's base edge, clipped to
[1/16, 16] before the log, under smooth-L1 (β 0.11). The head has no
GroupNorm: the `fovea_align_*` configs only carry the name, as in the JAX
package. The positive count is a global-batch count.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ...parallel.batch import batch_total
from ...utils.registry import DETECTORS, HEADS
from ..dense_heads.anchor_head import (DensePredictConfig, _rows,
                                       dense_predict, flatten_level_preds)
from ..layers.precision import Conv2d
from ..losses import sigmoid_focal_loss, smooth_l1_loss
from ..necks.fpn import FPN
from .retinanet import SingleStage, TowerHead, _nhwc

SCALE_RANGES = ((1, 64), (32, 128), (64, 256), (128, 512), (256, 2048))
BASE_EDGES = (16, 32, 64, 128, 256)


@HEADS.register_module()
class FoveaHead(TowerHead):
    """`fovea_cls` on the cls tower, `fovea_reg` (float32) on the reg
    tower."""

    def __init__(self, num_classes: int = 80, feat_channels: int = 256,
                 stacked_convs: int = 4, in_channels: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__(feat_channels, stacked_convs, in_channels,
                         dtype=dtype)
        self.fovea_cls = Conv2d(feat_channels, num_classes, 3, padding=1,
                                compute_dtype=dtype)
        self.fovea_reg = Conv2d(feat_channels, 4, 3, padding=1,
                                compute_dtype=dtype)

    def cls_output(self):
        return self.fovea_cls

    def outputs(self, c, r, lvl):
        return (_nhwc(self.fovea_cls(c).float()),
                _nhwc(self.fovea_reg(r).float()))


@functools.lru_cache(maxsize=32)
def _fovea_grid_np(sizes, strides):
    pts, base, lo, hi = [], [], [], []
    for li, ((h, w), s) in enumerate(zip(sizes, strides)):
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
        pts.append(np.stack([(xs.ravel() + 0.5) * s, (ys.ravel() + 0.5) * s],
                            -1).astype(np.float32))
        base.append(np.full((h * w,), BASE_EDGES[li], np.float32))
        lo.append(np.full((h * w,), SCALE_RANGES[li][0], np.float32))
        hi.append(np.full((h * w,), SCALE_RANGES[li][1], np.float32))
    return tuple(np.concatenate(a) for a in (pts, base, lo, hi))


def fovea_grid(featmap_sizes, strides, device='cpu'):
    """The levels' flat (N, 2) location centres ((x + 0.5)·s, (y + 0.5)·s)
    and (N,) base edges and scale-range bounds, on `device`."""
    return tuple(torch.from_numpy(a).to(device) for a in _fovea_grid_np(
        tuple(tuple(s) for s in featmap_sizes), tuple(strides)))


def fovea_loss(cls_logits: torch.Tensor, reg_preds: torch.Tensor,
               points: torch.Tensor, base: torch.Tensor, range_lo: torch.Tensor,
               range_hi: torch.Tensor, gt_bboxes: torch.Tensor,
               gt_labels: torch.Tensor, gt_valid: torch.Tensor,
               num_classes: int, sigma: float = 0.4
               ) -> Dict[str, torch.Tensor]:
    """FoveaBox's focal loss over every location and smooth-L1 of the
    positives' log corner distances, over the batch's positive count.
    cls_logits (B, N, C), reg_preds (B, N, 4)."""
    gt = gt_bboxes
    with torch.no_grad():
        area_sqrt = torch.sqrt(((gt[..., 2] - gt[..., 0])
                                * (gt[..., 3] - gt[..., 1])).clamp(min=0.0))
        a = area_sqrt[..., None]                               # (B, G, 1)
        in_scale = (a >= range_lo) & (a <= range_hi)           # (B, G, N)
        ctr = (gt[..., :2] + gt[..., 2:]) / 2
        half = (gt[..., 2:] - gt[..., :2]) / 2 * sigma
        lo, hi = (ctr - half)[..., None, :], (ctr + half)[..., None, :]
        in_fovea = ((points[:, 0] >= lo[..., 0]) & (points[:, 0] <= hi[..., 0])
                    & (points[:, 1] >= lo[..., 1])
                    & (points[:, 1] <= hi[..., 1]))
        cand = in_scale & in_fovea & gt_valid[..., None]
        inf = area_sqrt.new_tensor(float('inf'))
        area = torch.where(gt_valid, area_sqrt, inf)
        best = torch.argmin(torch.where(cand, area[..., None], inf), dim=1)
        pos = cand.any(dim=1)                                  # (B, N)
        labels = torch.where(pos, torch.gather(gt_labels.long(), 1, best),
                             torch.full_like(best, num_classes))
        gt_m = _rows(gt, best)
        t = torch.stack([(points[:, 0] - gt_m[..., 0]) / base,
                         (points[:, 1] - gt_m[..., 1]) / base,
                         (gt_m[..., 2] - points[:, 0]) / base,
                         (gt_m[..., 3] - points[:, 1]) / base], dim=-1)
        t = torch.log(t.clamp(1.0 / 16, 16.0))
    cls_l = sigmoid_focal_loss(cls_logits, labels, reduction='sum')
    pos_f = pos.float()[..., None]
    reg_l = smooth_l1_loss(reg_preds, t, weight=pos_f.expand_as(reg_preds),
                           beta=0.11, reduction='sum')
    denom = torch.clamp(batch_total(pos_f.sum()), min=1.0)
    return dict(loss_cls=cls_l / denom, loss_bbox=reg_l / denom)


@DETECTORS.register_module()
class FoveaBox(SingleStage):
    """RetinaNet's trunk and P3–P7 (extra convs on C5), `FoveaHead`,
    `fovea_loss`; served on the sigmoid scores, each box the location
    ± exp(reg) x the level's base edge."""

    def __init__(self, num_classes: int = 80, backbone_depth: int = 50,
                 backbone_cfg: Any = None, frozen_stages: int = 1,
                 strides: Tuple[int, ...] = (8, 16, 32, 64, 128),
                 sigma: float = 0.4,
                 test_cfg: DensePredictConfig = DensePredictConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__(num_classes, backbone_depth, backbone_cfg,
                         frozen_stages, dtype)
        self.strides = tuple(strides)
        self.sigma = sigma
        self.test_cfg = test_cfg
        self.neck = FPN(in_channels=self.backbone.stage_channels(),
                        out_channels=256, num_outs=5, start_level=1,
                        add_extra_convs='on_input', dtype=dtype)
        self.bbox_head = FoveaHead(num_classes=num_classes, dtype=dtype)

    def _flat(self, image):
        """→ cls (B, N, C), reg (B, N, 4), points (N, 2), base edges,
        scale-range bounds (N,)."""
        feats, sizes = self._levels(image)
        cls_lv, reg_lv = self.bbox_head(feats)
        return (flatten_level_preds(cls_lv, self.num_classes),
                flatten_level_preds(reg_lv, 4)) + fovea_grid(
                    sizes, self.strides, image.device)

    def loss(self, batch, generator=None, sampler_priorities=None):
        cls, reg, pts, base, lo, hi = self._flat(batch['image'])
        with record_function('step/dense_loss'):
            return fovea_loss(cls, reg, pts, base, lo, hi,
                              batch['gt_bboxes'].float(), batch['gt_labels'],
                              batch['gt_valid'], self.num_classes, self.sigma)

    @torch.inference_mode()
    def predict(self, batch):
        cls, reg, pts, base, _, _ = self._flat(batch['image'])

        def decode(idx):
            p = pts[idx]
            d = torch.exp(_rows(reg, idx)) * base[idx][..., None]
            return torch.stack([p[..., 0] - d[..., 0], p[..., 1] - d[..., 1],
                                p[..., 0] + d[..., 2], p[..., 1] + d[..., 3]],
                               dim=-1)

        return dense_predict(torch.sigmoid(cls), decode, batch['img_shape'],
                             self.num_classes, self.test_cfg)
