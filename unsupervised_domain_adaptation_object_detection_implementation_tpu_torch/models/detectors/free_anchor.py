"""FreeAnchor (counterpart of the JAX package's
`models/detectors/free_anchor.py`; reference
`mmdet/models/dense_heads/free_anchor_retina_head.py`) on RetinaNet's
trunk, neck, head and anchors.

Learning to match: each gt's bag is its `pre_anchor_topk` anchors of
highest IoU; the positive loss is −log of the bag's mean-max of
P(class) · P(location); the negative loss a focal-shaped penalty on every
anchor's class probability, scaled by 1 − the probability that the anchor
covers an object of that class (the saturated-linear transform of the
predicted boxes' IoU with the gts).

As in the JAX package: the bag is `lax.top_k` over all anchors, here
`topk_stable`, so anchors tied at an IoU (0, on small images) enter in its
order; the transform's upper threshold is clipped below at
`bbox_thr + 1e-12`, which in float32 equals `bbox_thr`, so where no
prediction passes it the quotient is ±inf (or nan at exactly the
threshold) before its clip to [0, 1], with no epsilon added; the clips
take `jnp.clip`'s gradient at a bound (`jax_clip`). The normalizer, the
batch's Σ valid gts, is a global-batch count.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.profiler import record_function

from ...core.bbox.iou import bbox_overlaps
from ...core.bbox.transforms import bbox2delta, delta2bbox
from ...core.post.nms import topk_stable
from ...parallel.batch import batch_total
from ...utils.registry import DETECTORS
from ..dense_heads.anchor_head import (DensePredictConfig, MultiAnchorConfig,
                                       dense_anchor_predict,
                                       flatten_level_preds, level_anchors)
from ..losses.utils import jax_clip, one_hot
from ..necks.fpn import FPN
from .retinanet import RetinaHead, SingleStage


def free_anchor_loss(cls_logits: torch.Tensor, reg_preds: torch.Tensor,
                     anchors: torch.Tensor, gt_bboxes: torch.Tensor,
                     gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                     num_classes: int, pre_anchor_topk: int = 50,
                     smooth_l1_beta: float = 0.11, gamma: float = 2.0,
                     alpha: float = 0.5, bbox_thr: float = 0.6
                     ) -> Dict[str, torch.Tensor]:
    """The positive and negative bag losses of cls_logits (B, N, C) and
    deltas reg_preds (B, N, 4) on anchors (N, 4), over the batch's valid
    gts (and x `pre_anchor_topk` for the negative)."""
    c = num_classes
    p_cls = torch.sigmoid(cls_logits.float())                  # (B, N, C)
    reg = reg_preds.float()
    gtv = gt_valid[..., None]
    ious = torch.where(gtv, bbox_overlaps(gt_bboxes, anchors),
                       anchors.new_tensor(-1.0))               # (B, G, N)
    gl = gt_labels.long().clamp(0, c - 1)

    # the negative loss: P(anchor n covers an object of class c)
    with torch.no_grad():
        boxes = delta2bbox(anchors, reg)
        pred_ious = bbox_overlaps(gt_bboxes, boxes)            # (B, G, N)
        t1 = bbox_thr
        top = torch.where(gtv, pred_ious, pred_ious.new_zeros(())).amax(
            -1, keepdim=True)
        t2 = torch.maximum(top, top.new_tensor(t1 + 1e-12))
        box_prob = ((pred_ious - t1) / (t2 - t1)).clamp(0, 1)
        box_prob = torch.where(gtv, box_prob, box_prob.new_zeros(()))
        onehot = one_hot(gl, c) * gt_valid[..., None].float()  # (B, G, C)
        cls_prob = torch.matmul(box_prob.transpose(1, 2), onehot).clamp(0, 1)
    neg_prob = p_cls * (1 - cls_prob)
    neg_l = -(1 - alpha) * neg_prob ** gamma * torch.log(
        jax_clip(1 - neg_prob, 1e-12))

    # the positive bag loss
    k = min(pre_anchor_topk, anchors.shape[0])
    with record_function('step/free_anchor_bag'):
        _, top_idx = topk_stable(ious, k)                      # (B, G, K)
    b, g = top_idx.shape[:2]
    flat_idx = top_idx.reshape(b, g * k)
    bag_cls = torch.gather(
        torch.gather(p_cls, 1, flat_idx[..., None].expand(b, g * k, c)
                     ).reshape(b, g, k, c), -1,
        gl[..., None, None].expand(b, g, k, 1))[..., 0]
    bag_anchors = anchors[top_idx]                             # (B, G, K, 4)
    d_t = bbox2delta(bag_anchors, gt_bboxes[:, :, None, :].expand_as(
        bag_anchors))
    d_p = torch.gather(reg, 1, flat_idx[..., None].expand(b, g * k, 4)
                       ).reshape(b, g, k, 4)
    diff = (d_p - d_t).abs()
    sl1 = torch.where(diff < smooth_l1_beta,
                      0.5 * diff ** 2 / smooth_l1_beta,
                      diff - 0.5 * smooth_l1_beta)
    bag_loc = torch.exp(-sl1.sum(-1))
    joint = jax_clip(bag_cls * bag_loc, 1e-12, 1 - 1e-6)
    w = 1.0 / (1.0 - joint)
    w = w / w.sum(-1, keepdim=True)
    bag_prob = (joint * w).sum(-1)
    pos_l = -alpha * torch.log(jax_clip(bag_prob, 1e-12))
    pos_loss = torch.where(gt_valid, pos_l, pos_l.new_zeros(())).sum()
    n = torch.clamp(batch_total(gt_valid.sum().float()), min=1.0)
    return dict(positive_bag_loss=pos_loss / n,
                negative_bag_loss=neg_l.sum() / (n * pre_anchor_topk))


@DETECTORS.register_module()
class FreeAnchor(SingleStage):
    """RetinaNet's trunk, P3–P7 (extra convs on C5), `RetinaHead` and its
    9 anchors a location, trained with `free_anchor_loss`; served as
    RetinaNet (`dense_anchor_predict`)."""

    def __init__(self, num_classes: int = 80, backbone_depth: int = 50,
                 backbone_cfg: Any = None, frozen_stages: int = 1,
                 strides: Tuple[int, ...] = (8, 16, 32, 64, 128),
                 pre_anchor_topk: int = 50, smooth_l1_beta: float = 0.11,
                 gamma: float = 2.0, alpha: float = 0.5,
                 bbox_thr: float = 0.6,
                 test_cfg: DensePredictConfig = DensePredictConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__(num_classes, backbone_depth, backbone_cfg,
                         frozen_stages, dtype)
        self.strides = tuple(strides)
        self.pre_anchor_topk = pre_anchor_topk
        self.smooth_l1_beta = smooth_l1_beta
        self.gamma = gamma
        self.alpha = alpha
        self.bbox_thr = bbox_thr
        self.test_cfg = test_cfg
        self.neck = FPN(in_channels=self.backbone.stage_channels(),
                        out_channels=256, num_outs=5, start_level=1,
                        add_extra_convs='on_input', dtype=dtype)
        self.bbox_head = RetinaHead(num_classes=num_classes, dtype=dtype)

    def _flat(self, image: torch.Tensor):
        """→ cls (B, N, C), reg (B, N, 4), anchors (N, 4)."""
        feats, sizes = self._levels(image)
        cls_lv, reg_lv = self.bbox_head(feats)
        cfg = MultiAnchorConfig(strides=self.strides)
        anchors, _ = level_anchors(cfg.strides, cfg.ratios, cfg.scales, sizes,
                                   image.device)
        return (flatten_level_preds(cls_lv, self.num_classes),
                flatten_level_preds(reg_lv, 4), anchors)

    def loss(self, batch, generator=None, sampler_priorities=None):
        cls, reg, anchors = self._flat(batch['image'])
        with record_function('step/dense_loss'):
            return free_anchor_loss(
                cls, reg, anchors, batch['gt_bboxes'].float(),
                batch['gt_labels'], batch['gt_valid'], self.num_classes,
                self.pre_anchor_topk, self.smooth_l1_beta, self.gamma,
                self.alpha, self.bbox_thr)

    @torch.inference_mode()
    def predict(self, batch) -> Dict[str, torch.Tensor]:
        cls, reg, anchors = self._flat(batch['image'])
        return dense_anchor_predict(cls, reg, anchors, batch['img_shape'],
                                    self.num_classes, self.test_cfg)
