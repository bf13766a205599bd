"""FSAF (counterpart of the JAX package's `models/detectors/fsaf.py`;
reference `mmdet/models/dense_heads/fsaf_head.py`): the feature-selective
anchor-free branch on RetinaNet's towers.

Each gt's effective region (its centre `pos_scale` of the box) trains one
pyramid level, chosen online as the level with the lowest mean candidate
loss over that region (focal-style −log p of the gt's class plus
−log IoU of the decoded box, both on detached predictions); its shadow
region (`ignore_scale`) outside the chosen positives is left out of the
classification. The regression is (top, bottom, left, right) distances
in units of stride x `normalize_factor`, relu(x) + 1e-4 in float32.

The level choice is a dense (B, G, L) matrix of masked means, `inf` on an
empty level, whose argmin takes the first of tied minima (the lowest
level), as `jnp.argmin` does; a point claimed by several gts goes to the
smallest (the first of equal areas). The positive count is a global-batch
count.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ...core.bbox.coders import tblr2bbox
from ...parallel.batch import batch_total
from ...utils.registry import DETECTORS, HEADS
from ..dense_heads.anchor_head import (DensePredictConfig, _rows,
                                       dense_predict, flatten_level_preds)
from ..layers.precision import Conv2d
from ..losses import iou_loss, sigmoid_focal_loss
from ..losses.utils import jax_max
from ..necks.fpn import FPN
from .retinanet import SingleStage, TowerHead, _nhwc


@HEADS.register_module()
class FSAFHead(TowerHead):
    """`retina_cls` on the cls tower, `retina_reg` (relu + 1e-4, float32)
    on the reg tower, one location a prior."""

    def __init__(self, num_classes: int = 80, feat_channels: int = 256,
                 stacked_convs: int = 4, in_channels: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__(feat_channels, stacked_convs, in_channels,
                         dtype=dtype)
        self.retina_cls = Conv2d(feat_channels, num_classes, 3, padding=1,
                                 compute_dtype=dtype)
        self.retina_reg = Conv2d(feat_channels, 4, 3, padding=1,
                                 compute_dtype=dtype)

    def cls_output(self):
        return self.retina_cls

    def outputs(self, c, r, lvl):
        return (_nhwc(self.retina_cls(c).float()),
                _nhwc(torch.relu(self.retina_reg(r).float()) + 1e-4))


@functools.lru_cache(maxsize=32)
def _fsaf_points_np(sizes, strides):
    pts, strs, lvl = [], [], []
    for li, ((h, w), s) in enumerate(zip(sizes, strides)):
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
        pts.append(np.stack([xs.ravel() * s + s / 2, ys.ravel() * s + s / 2],
                            -1).astype(np.float32))
        strs.append(np.full((h * w,), s, np.float32))
        lvl.append(np.full((h * w,), li, np.int64))
    return np.concatenate(pts), np.concatenate(strs), np.concatenate(lvl)


def fsaf_points(featmap_sizes, strides, device='cpu'):
    """The levels' flat (N, 2) points (x·s + s/2, y·s + s/2), (N,) strides
    and (N,) level indices, on `device`."""
    return tuple(torch.from_numpy(a).to(device) for a in _fsaf_points_np(
        tuple(tuple(s) for s in featmap_sizes), tuple(strides)))


def _inside(gt: torch.Tensor, pts: torch.Tensor, scale: float
            ) -> torch.Tensor:
    """(B, G, N): points inside the centre `scale` of each gt box."""
    ctr = (gt[..., :2] + gt[..., 2:]) / 2
    half = (gt[..., 2:] - gt[..., :2]) / 2
    lo = (ctr - half * scale)[..., None, :]
    hi = (ctr + half * scale)[..., None, :]
    return ((pts[:, 0] >= lo[..., 0]) & (pts[:, 0] <= hi[..., 0])
            & (pts[:, 1] >= lo[..., 1]) & (pts[:, 1] <= hi[..., 1]))


def select_levels(mean_loss: torch.Tensor) -> torch.Tensor:
    """(..., L) mean candidate losses → (...,) the level of least loss, the
    first of tied minima (`torch.argmin`'s order and `jnp.argmin`'s)."""
    return torch.argmin(mean_loss, dim=-1)


def fsaf_loss(cls_logits: torch.Tensor, reg_preds: torch.Tensor,
              points: torch.Tensor, strides: torch.Tensor,
              levels: torch.Tensor, num_levels: int, gt_bboxes: torch.Tensor,
              gt_labels: torch.Tensor, gt_valid: torch.Tensor,
              num_classes: int, pos_scale: float = 0.2,
              ignore_scale: float = 0.5, normalize_factor: float = 4.0
              ) -> Dict[str, torch.Tensor]:
    """FSAF's focal loss (shadow regions unweighted) and IoU loss of the
    positives' TBLR boxes over the batch's positive count. cls_logits
    (B, N, C), reg_preds (B, N, 4); points (N, 2), strides (N,), levels
    (N,)."""
    gtv = gt_valid[..., None]
    in_core = _inside(gt_bboxes, points, pos_scale) & gtv      # (B, G, N)
    in_shadow = _inside(gt_bboxes, points, ignore_scale) & gtv
    priors = torch.cat([points, points], dim=-1)
    norm = strides * normalize_factor
    area_g = (gt_bboxes[..., 2] - gt_bboxes[..., 0]) * \
        (gt_bboxes[..., 3] - gt_bboxes[..., 1])                # (B, G)
    dec_live = tblr2bbox(priors, reg_preds.float() * norm[:, None],
                         normalizer=1.0, normalize_by_wh=False)  # (B, N, 4)
    with torch.no_grad():
        p_cls = torch.sigmoid(cls_logits.float())
        gl = gt_labels.long().clamp(0, num_classes - 1)
        p_at = torch.gather(p_cls, 2, gl[:, None, :].expand(
            -1, p_cls.shape[1], -1)).transpose(1, 2)           # (B, G, N)
        cand_cls = -torch.log(torch.clamp(p_at, min=1e-8))
        dec = dec_live.detach()
        d, gtb = dec[:, None], gt_bboxes[:, :, None]
        iw = (torch.minimum(d[..., 2], gtb[..., 2])
              - torch.maximum(d[..., 0], gtb[..., 0])).clamp(min=0)
        ih = (torch.minimum(d[..., 3], gtb[..., 3])
              - torch.maximum(d[..., 1], gtb[..., 1])).clamp(min=0)
        inter = iw * ih
        area_d = ((dec[..., 2] - dec[..., 0])
                  * (dec[..., 3] - dec[..., 1])).clamp(min=1e-6)
        iou = inter / (area_d[:, None, :] + area_g[..., None]
                       - inter).clamp(min=1e-6)
        cand = cand_cls - torch.log(iou.clamp(min=1e-8))
        lvl_onehot = (levels[:, None] == torch.arange(
            num_levels, device=levels.device)).float()         # (N, L)
        w = in_core.float()
        sums = torch.matmul(w * cand, lvl_onehot)              # (B, G, L)
        cnts = torch.matmul(w, lvl_onehot)
        mean_l = torch.where(cnts > 0, sums / cnts.clamp(min=1),
                             sums.new_tensor(float('inf')))
        best_lvl = select_levels(mean_l)                       # (B, G)

        sel = in_core & (levels == best_lvl[..., None])
        area = torch.where(gt_valid, area_g, area_g.new_tensor(float('inf')))
        key = torch.where(sel, area[..., None], area.new_tensor(float('inf')))
        best_gt = torch.argmin(key, dim=1)                     # (B, N)
        pos = sel.any(dim=1)
        ignore = in_shadow.any(dim=1) & ~pos
        labels = torch.where(pos, torch.gather(gt_labels.long(), 1, best_gt),
                             torch.full_like(best_gt, num_classes))
        gt_m = _rows(gt_bboxes, best_gt)
    w_cls = torch.where(ignore, 0.0, 1.0)
    cls_l = sigmoid_focal_loss(cls_logits, labels, weight=w_cls[..., None],
                               reduction='sum')
    pos_f = pos.float()
    reg_l = iou_loss(dec_live, gt_m, weight=pos_f, reduction='sum')
    denom = torch.clamp(batch_total(pos_f.sum()), min=1.0)
    return dict(loss_cls=cls_l / denom, loss_bbox=reg_l / denom)


@DETECTORS.register_module()
class FSAF(SingleStage):
    """RetinaNet's trunk and P3–P7 (extra convs on C5), `FSAFHead`,
    `fsaf_loss`; served on the sigmoid scores with the TBLR decode."""

    def __init__(self, num_classes: int = 80, backbone_depth: int = 50,
                 backbone_cfg: Any = None, frozen_stages: int = 1,
                 strides: Tuple[int, ...] = (8, 16, 32, 64, 128),
                 pos_scale: float = 0.2, ignore_scale: float = 0.5,
                 normalize_factor: float = 4.0,
                 test_cfg: DensePredictConfig = DensePredictConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__(num_classes, backbone_depth, backbone_cfg,
                         frozen_stages, dtype)
        self.strides = tuple(strides)
        self.pos_scale = pos_scale
        self.ignore_scale = ignore_scale
        self.normalize_factor = normalize_factor
        self.test_cfg = test_cfg
        self.neck = FPN(in_channels=self.backbone.stage_channels(),
                        out_channels=256, num_outs=5, start_level=1,
                        add_extra_convs='on_input', dtype=dtype)
        self.bbox_head = FSAFHead(num_classes=num_classes, dtype=dtype)

    def _flat(self, image):
        """→ cls (B, N, C), reg (B, N, 4), points (N, 2), strides (N,),
        levels (N,)."""
        feats, sizes = self._levels(image)
        cls_lv, reg_lv = self.bbox_head(feats)
        return (flatten_level_preds(cls_lv, self.num_classes),
                flatten_level_preds(reg_lv, 4)) + fsaf_points(
                    sizes, self.strides, image.device)

    def loss(self, batch, generator=None, sampler_priorities=None):
        cls, reg, pts, strs, lvl = self._flat(batch['image'])
        with record_function('step/dense_loss'):
            return fsaf_loss(cls, reg, pts, strs, lvl, len(self.strides),
                             batch['gt_bboxes'].float(), batch['gt_labels'],
                             batch['gt_valid'], self.num_classes,
                             self.pos_scale, self.ignore_scale,
                             self.normalize_factor)

    @torch.inference_mode()
    def predict(self, batch):
        cls, reg, pts, strs, _ = self._flat(batch['image'])
        dist = reg * (strs * self.normalize_factor)[:, None]
        priors = torch.cat([pts, pts], dim=-1)

        def decode(idx):
            return tblr2bbox(priors[idx], _rows(dist, idx), normalizer=1.0,
                             normalize_by_wh=False)

        return dense_predict(torch.sigmoid(cls), decode, batch['img_shape'],
                             self.num_classes, self.test_cfg)
