"""FCOS (counterpart of the JAX package's `models/detectors/fcos.py`):
per-location classification, (l, t, r, b) distances and centerness, the
gts assigned to the levels by scale range.

The head has no GroupNorm: the JAX `FCOSHead` has none, and the `gn-head`
configs only carry the name. Its distances are exp(conv · `scale_{lvl}`)
in float32, in stride units (the reference's `norm_on_bbox` form, which
every config here uses). The targets are a dense (B, N, G) reduction:
points inside the gt (and, with `center_sampling`, inside a box of
±radius · stride about its centre, clipped to it) whose largest distance
lies in their level's range (inclusive at both ends), the smallest-area
gt winning.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ...core.bbox.coders import bbox2distance, distance2bbox
from ...parallel.batch import batch_total
from ...utils.registry import DETECTORS, HEADS
from ..dense_heads.anchor_head import (DensePredictConfig, _rows,
                                       dense_predict, flatten_level_preds)
from ..layers.precision import Conv2d
from ..losses import binary_cross_entropy, giou_loss, sigmoid_focal_loss
from ..losses.utils import jax_max
from ..necks.fpn import FPN
from .retinanet import SingleStage, TowerHead, _nhwc

INF = 1e8
REGRESS_RANGES = ((-1, 64), (64, 128), (128, 256), (256, 512), (512, INF))


@HEADS.register_module()
class FCOSHead(TowerHead):
    """`fcos_cls` on the cls tower; `fcos_reg` (its exp(· scale)) and, with
    `centerness_on_reg`, `fcos_centerness` on the reg tower (else on the
    cls tower); `dcn_on_last_conv` makes each tower's last conv a DCN v1."""

    def __init__(self, num_classes: int = 80, feat_channels: int = 256,
                 stacked_convs: int = 4, in_channels: int = 256,
                 num_levels: int = 5, centerness_on_reg: bool = True,
                 dcn_on_last_conv: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__(feat_channels, stacked_convs, in_channels,
                         num_levels, dcn_on_last_conv, dtype)
        self.centerness_on_reg = centerness_on_reg
        conv = functools.partial(Conv2d, compute_dtype=dtype)
        self.fcos_cls = conv(feat_channels, num_classes, 3, padding=1)
        self.fcos_reg = conv(feat_channels, 4, 3, padding=1)
        self.fcos_centerness = conv(feat_channels, 1, 3, padding=1)

    def cls_output(self):
        return self.fcos_cls

    def outputs(self, c, r, lvl):
        return (_nhwc(self.fcos_cls(c).float()),
                _nhwc(torch.exp(self.fcos_reg(r).float() * self.scale(lvl))),
                _nhwc(self.fcos_centerness(
                    r if self.centerness_on_reg else c).float()))


@functools.lru_cache(maxsize=32)
def _fcos_points_np(sizes, strides):
    pts, strs, ranges = [], [], []
    for (h, w), s, rng in zip(sizes, strides, REGRESS_RANGES):
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
        pts.append(np.stack([xs.ravel() * s + s // 2,
                             ys.ravel() * s + s // 2], -1).astype(np.float32))
        strs.append(np.full((h * w,), s, np.float32))
        ranges.append(np.tile(np.asarray(rng, np.float32), (h * w, 1)))
    return (np.concatenate(pts), np.concatenate(strs),
            np.concatenate(ranges))


def fcos_points(featmap_sizes, strides, device='cpu'
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The levels' flat (N, 2) point centres (x·s + s // 2, y·s + s // 2),
    (N,) strides and (N, 2) regression ranges, on `device`."""
    return tuple(torch.from_numpy(a).to(device) for a in _fcos_points_np(
        tuple(tuple(s) for s in featmap_sizes), tuple(strides)))


def centerness_target(d: torch.Tensor) -> torch.Tensor:
    """sqrt of the (l, t, r, b) distances' min/max ratios' product,
    clamped to [0, 1] before the sqrt (a point outside its box gets 0)."""
    lr, tb = d[..., [0, 2]], d[..., [1, 3]]
    ratio = (lr.amin(-1) / jax_max(lr.amax(-1), 1e-6)) * \
        (tb.amin(-1) / jax_max(tb.amax(-1), 1e-6))
    return torch.sqrt(ratio.clamp(0.0, 1.0))


def fcos_loss(cls_logits, reg_dists, ctr_logits, points, strides, ranges,
              gt_bboxes, gt_labels, gt_valid, num_classes,
              center_sampling: bool = False,
              center_sample_radius: float = 1.5) -> Dict[str, torch.Tensor]:
    """FCOS's targets and losses: focal over every point, GIoU of the
    positives' boxes weighted by their centerness target over the batch's
    Σ centerness, BCE of the centerness over the positive count.
    cls_logits (B, N, C), reg_dists (B, N, 4) in stride units, ctr_logits
    (B, N, 1); points (N, 2), strides (N,), ranges (N, 2)."""
    px, py = points[:, 0, None], points[:, 1, None]            # (N, 1)
    gt = gt_bboxes[:, None]                                    # (B, 1, G, 4)
    d = torch.stack([px - gt[..., 0], py - gt[..., 1],
                     gt[..., 2] - px, gt[..., 3] - py], -1)    # (B, N, G, 4)
    inside = d.amin(-1) > 0
    if center_sampling:
        cx = (gt[..., 0] + gt[..., 2]) * 0.5
        cy = (gt[..., 1] + gt[..., 3]) * 0.5
        rad = strides[:, None] * center_sample_radius
        inside = inside & (
            (px > torch.maximum(cx - rad, gt[..., 0]))
            & (px < torch.minimum(cx + rad, gt[..., 2]))
            & (py > torch.maximum(cy - rad, gt[..., 1]))
            & (py < torch.minimum(cy + rad, gt[..., 3])))
    maxd = d.amax(-1)
    in_range = (maxd >= ranges[:, None, 0]) & (maxd <= ranges[:, None, 1])
    areas = (gt_bboxes[..., 2] - gt_bboxes[..., 0]) * \
        (gt_bboxes[..., 3] - gt_bboxes[..., 1])                # (B, G)
    cand = inside & in_range & gt_valid[:, None, :]
    area_mat = torch.where(cand, areas[:, None, :], areas.new_tensor(INF))
    min_area, matched = area_mat.min(-1)                       # first min
    pos = min_area < INF
    labels = torch.where(pos, torch.gather(gt_labels.long(), 1, matched),
                         torch.full_like(matched, num_classes))
    cls_l = sigmoid_focal_loss(cls_logits, labels, reduction='sum')
    gt_m = _rows(gt_bboxes, matched)
    ctr_t = centerness_target(bbox2distance(points, gt_m))
    pos_f = pos.float()
    boxes = distance2bbox(points, reg_dists * strides[:, None])
    reg_l = giou_loss(boxes, gt_m, weight=pos_f * ctr_t, reduction='sum')
    ctr_l = binary_cross_entropy(ctr_logits[..., 0], ctr_t, weight=pos_f,
                                 reduction='sum')
    denom = torch.clamp(batch_total(pos_f.sum()), min=1.0)
    ctr_sum = torch.clamp(batch_total((pos_f * ctr_t).sum()), min=1e-6)
    return dict(loss_cls=cls_l / denom, loss_bbox=reg_l / ctr_sum,
                loss_centerness=ctr_l / denom)


@DETECTORS.register_module()
class FCOS(SingleStage):
    """FCOS: P3–P7 (extra convs on P5, a ReLU before the second), the
    `FCOSHead`, `fcos_loss`; `predict` scores sigmoid(cls) · sigmoid(ctr).
    `norm_on_bbox` is accepted for the configs: the head always regresses
    stride-normalized distances."""

    def __init__(self, num_classes: int = 80, backbone_depth: int = 50,
                 backbone_cfg: Any = None, frozen_stages: int = 1,
                 strides: Tuple[int, ...] = (8, 16, 32, 64, 128),
                 center_sampling: bool = False,
                 center_sample_radius: float = 1.5,
                 centerness_on_reg: bool = True, norm_on_bbox: bool = True,
                 dcn_on_last_conv: bool = False,
                 test_cfg: DensePredictConfig = DensePredictConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__(num_classes, backbone_depth, backbone_cfg,
                         frozen_stages, dtype)
        self.strides = tuple(strides)
        self.center_sampling = center_sampling
        self.center_sample_radius = center_sample_radius
        self.test_cfg = test_cfg
        self.neck = FPN(in_channels=self.backbone.stage_channels(),
                        out_channels=256, num_outs=5, start_level=1,
                        add_extra_convs='on_output',
                        relu_before_extra_convs=True, dtype=dtype)
        self.bbox_head = FCOSHead(num_classes=num_classes,
                                  num_levels=len(self.strides),
                                  centerness_on_reg=centerness_on_reg,
                                  dcn_on_last_conv=dcn_on_last_conv,
                                  dtype=dtype)

    def _flat(self, image):
        """→ cls (B, N, C), reg (B, N, 4), ctr (B, N, 1), points (N, 2),
        strides (N,), ranges (N, 2)."""
        feats, sizes = self._levels(image)
        cls_lv, reg_lv, ctr_lv = self.bbox_head(feats)
        return (flatten_level_preds(cls_lv, self.num_classes),
                flatten_level_preds(reg_lv, 4),
                flatten_level_preds(ctr_lv, 1)) + fcos_points(
                    sizes, self.strides, image.device)

    def loss(self, batch, generator=None, sampler_priorities=None):
        cls, reg, ctr, pts, strs, rngs = self._flat(batch['image'])
        with record_function('step/dense_loss'):
            return fcos_loss(cls, reg, ctr, pts, strs, rngs,
                             batch['gt_bboxes'].float(), batch['gt_labels'],
                             batch['gt_valid'], self.num_classes,
                             self.center_sampling, self.center_sample_radius)

    @torch.inference_mode()
    def predict(self, batch):
        cls, reg, ctr, pts, strs, _ = self._flat(batch['image'])
        dist = reg * strs[:, None]

        def decode(idx):
            return distance2bbox(pts[idx], _rows(dist, idx))

        return dense_predict(torch.sigmoid(cls) * torch.sigmoid(ctr),
                             decode, batch['img_shape'], self.num_classes,
                             self.test_cfg)
