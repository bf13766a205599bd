"""SABL, side-aware boundary localization (counterpart of the JAX
package's `models/detectors/sabl_retina.py`; reference
`mmdet/models/dense_heads/sabl_retina_head.py`, `roi_heads/bbox_heads/
sabl_head.py`, `core/bbox/coder/bucketing_bbox_coder.py`).

`SABLRetinaNet`: RetinaNet's towers with one square anchor (scale 4) a
location, classified on the max-IoU assignment (0.5 / 0.4, no inside
flags); the reg tower predicts each side's bucket logits and in-bucket
offsets (`core/bbox/extra_coders.py`), decoded by `bucket2bbox`, whose
localisation confidence rescales the class score before NMS.

`SABLFasterRCNN`: the FPN RPN and proposals of `FasterRCNNFPN`, then the
SABL box head (`SABLBBoxHead`) on the sampled RoIs' 7x7 features;
`cascade=True` runs two such stages (IoU 0.5, then 0.6, without
low-quality matches), the second on the first's detached bucket decode of
its sampled RoIs, and serves with the last stage's scores. Each stage
draws its sampler priorities under the cascade family's keys ('rcnn',
'rcnn_1'). The normalizers are global-batch counts; the cascade form
trains on one device, as the cascade family does.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from ...core.bbox.extra_coders import bbox2bucket, bucket2bbox
from ...core.bbox.transforms import clip_boxes
from ...parallel.batch import batch_total
from ...utils.registry import DETECTORS, HEADS
from ..dense_heads.anchor_head import (DensePredictConfig, _rows,
                                       flatten_level_preds, level_anchors,
                                       nms_detections, top_scores)
from ..layers.precision import Conv1d, Conv2d, ConvTranspose1d, Linear
from ..losses import (binary_cross_entropy, sigmoid_focal_loss,
                      smooth_l1_loss, softmax_cross_entropy)
from ..dense_heads.rpn_head import ProposalConfig
from ..necks.fpn import FPN
from ..roi_heads.standard_roi_head import (RoITestConfig, RoITrainConfig,
                                           SampledRoIs, sample_rois)
from ...core.bbox.assigners import max_iou_assign
from .cascade_rcnn import stage_priority_key
from .faster_rcnn_fpn import FPNProposer
from .retinanet import SingleStage, TowerHead, _nhwc

NUM_BUCKETS = 14
SIDE_NUM = 7   # ceil(NUM_BUCKETS / 2)


@HEADS.register_module()
class SABLRetinaHead(TowerHead):
    """`retina_cls` on the cls tower; `bucket_cls` and `bucket_offset`
    (4 x SIDE_NUM each, float32) on the reg tower."""

    def __init__(self, num_classes: int = 80, feat_channels: int = 256,
                 stacked_convs: int = 4, in_channels: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__(feat_channels, stacked_convs, in_channels,
                         dtype=dtype)
        conv = functools.partial(Conv2d, compute_dtype=dtype)
        self.retina_cls = conv(feat_channels, num_classes, 3, padding=1)
        self.bucket_cls = conv(feat_channels, 4 * SIDE_NUM, 3, padding=1)
        self.bucket_offset = conv(feat_channels, 4 * SIDE_NUM, 3, padding=1)

    def cls_output(self):
        return self.retina_cls

    def outputs(self, c, r, lvl):
        return (_nhwc(self.retina_cls(c).float()),
                _nhwc(self.bucket_cls(r).float()),
                _nhwc(self.bucket_offset(r).float()))


def sabl_retina_loss(cls_logits: torch.Tensor, bucket_cls: torch.Tensor,
                     bucket_off: torch.Tensor, anchors: torch.Tensor,
                     gt_bboxes: torch.Tensor, gt_labels: torch.Tensor,
                     gt_valid: torch.Tensor, num_classes: int,
                     scale_factor: float = 1.7) -> Dict[str, torch.Tensor]:
    """The focal loss over every anchor, the positives' bucket BCE (x 0.5)
    and offsets' smooth-L1 (β 1/9), over the batch's positive count.
    cls_logits (B, N, C), bucket_cls / bucket_off (B, N, 4 · SIDE_NUM),
    anchors (N, 4)."""
    with torch.no_grad():
        a = max_iou_assign(anchors, gt_bboxes, gt_valid, gt_labels,
                           pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0)
        pos = a.assigned_gt_inds > 0
        labels = torch.where(pos, a.labels.long(),
                             torch.full_like(a.labels.long(), num_classes))
        m = (a.assigned_gt_inds - 1).clamp(0, gt_bboxes.shape[1] - 1)
        offs, offw, blabels, bclsw = bbox2bucket(
            anchors, _rows(gt_bboxes, m), NUM_BUCKETS, scale_factor)
    cls_l = sigmoid_focal_loss(cls_logits, labels, reduction='sum')
    pos_f = pos.float()[..., None]
    bce = binary_cross_entropy(bucket_cls, blabels, reduction='none')
    bcls_l = (bce * bclsw * pos_f).sum()
    boff_l = smooth_l1_loss(bucket_off, offs, weight=offw * pos_f,
                            beta=1.0 / 9.0, reduction='sum')
    denom = torch.clamp(batch_total(pos_f.sum()), min=1.0)
    return dict(loss_cls=cls_l / denom, loss_bbox_cls=0.5 * bcls_l / denom,
                loss_bbox_reg=boff_l / denom)


@DETECTORS.register_module()
class SABLRetinaNet(SingleStage):
    """RetinaNet's trunk and P3–P7 (extra convs on C5), `SABLRetinaHead`
    on square anchors, `sabl_retina_loss`; served on top-k sigmoid scores
    x the bucket decode's confidence."""

    def __init__(self, num_classes: int = 80, backbone_depth: int = 50,
                 backbone_cfg: Any = None, frozen_stages: int = 1,
                 strides: Tuple[int, ...] = (8, 16, 32, 64, 128),
                 scale_factor: float = 1.7,
                 test_cfg: DensePredictConfig = DensePredictConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__(num_classes, backbone_depth, backbone_cfg,
                         frozen_stages, dtype)
        self.strides = tuple(strides)
        self.scale_factor = scale_factor
        self.test_cfg = test_cfg
        self.neck = FPN(in_channels=self.backbone.stage_channels(),
                        out_channels=256, num_outs=5, start_level=1,
                        add_extra_convs='on_input', dtype=dtype)
        self.bbox_head = SABLRetinaHead(num_classes=num_classes, dtype=dtype)

    def _flat(self, image):
        """→ cls (B, N, C), bucket logits and offsets (B, N, 28), anchors
        (N, 4)."""
        feats, sizes = self._levels(image)
        cls_lv, bc_lv, bo_lv = self.bbox_head(feats)
        anchors, _ = level_anchors(self.strides, (1.0,), (4,), sizes,
                                   image.device)
        return (flatten_level_preds(cls_lv, self.num_classes),
                flatten_level_preds(bc_lv, 4 * SIDE_NUM),
                flatten_level_preds(bo_lv, 4 * SIDE_NUM), anchors)

    def loss(self, batch, generator=None, sampler_priorities=None):
        cls, bc, bo, anchors = self._flat(batch['image'])
        with record_function('step/dense_loss'):
            return sabl_retina_loss(cls, bc, bo, anchors,
                                    batch['gt_bboxes'].float(),
                                    batch['gt_labels'], batch['gt_valid'],
                                    self.num_classes, self.scale_factor)

    @torch.inference_mode()
    def predict(self, batch) -> Dict[str, torch.Tensor]:
        cls, bc, bo, anchors = self._flat(batch['image'])
        c = self.num_classes
        top, idx = top_scores(torch.sigmoid(cls), self.test_cfg)
        a_idx = idx // c
        boxes, conf = bucket2bbox(anchors[a_idx], _rows(bc, a_idx),
                                  _rows(bo, a_idx), NUM_BUCKETS,
                                  self.scale_factor)
        boxes = clip_boxes(boxes, batch['img_shape'][:, None, :].float())
        return nms_detections(boxes, top * conf, idx % c, self.test_cfg)


@HEADS.register_module()
class SABLBBoxHead(nn.Module):
    """The SABL RoI head on (B, S, o, o, C) features: a 2-fc classifier
    (`cls_fc1`, `cls_fc2`, `cls_out`, C + 1 softmax logits) and the
    side-aware regression: two 3x3 convs (`reg_pre{0,1}`), max over y (for
    the x sides) and over x (the y sides), a stride-2 transposed conv to 14
    positions (`up_x`, `up_y`), a 3-tap conv (`reg_post_x`, `reg_post_y`)
    and per-position bucket logit and offset predictors (`bucket_cls_x`,
    `bucket_off_x`, ...); positions 0..6 are the near side's buckets,
    13..7 (in that order) the far side's. Returns (cls (B, S, C + 1),
    bucket logits and offsets (B, S, 28) float32)."""

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 feat_channels: int = 256, fc_channels: int = 1024,
                 roi_size: int = 7, dtype: torch.dtype = torch.float32):
        super().__init__()
        lin = functools.partial(Linear, compute_dtype=dtype)
        self.cls_fc1 = lin(roi_size * roi_size * in_channels, fc_channels)
        self.cls_fc2 = lin(fc_channels, fc_channels)
        self.cls_out = lin(fc_channels, num_classes + 1)
        self.reg_pre0 = Conv2d(in_channels, feat_channels, 3, padding=1,
                               compute_dtype=dtype)
        self.reg_pre1 = Conv2d(feat_channels, feat_channels, 3, padding=1,
                               compute_dtype=dtype)
        for axis in ('x', 'y'):
            self.add_module(f'up_{axis}', ConvTranspose1d(
                feat_channels, feat_channels, 2, stride=2,
                compute_dtype=dtype))
            self.add_module(f'reg_post_{axis}', Conv1d(
                feat_channels, feat_channels, 3, padding=1,
                compute_dtype=dtype))
            self.add_module(f'bucket_cls_{axis}', lin(feat_channels, 1))
            self.add_module(f'bucket_off_{axis}', lin(feat_channels, 1))

    def predictors(self):
        """(the classifier, the bucket logit predictors, the offset
        predictors): the layers mmdet draws at std 0.01, 0.01 and 0.001."""
        return (self.cls_out, [self.bucket_cls_x, self.bucket_cls_y],
                [self.bucket_off_x, self.bucket_off_y])

    def _sides(self, feat: torch.Tensor, axis: str):
        """(BS, C, 14) position features → ((near, far) logits, (near, far)
        offsets), each (BS, SIDE_NUM)."""
        f = feat.transpose(1, 2)
        out = []
        for kind in ('cls', 'off'):
            v = getattr(self, f'bucket_{kind}_{axis}')(f)[..., 0]
            out.append((v[:, :SIDE_NUM], v[:, SIDE_NUM:].flip(-1)))
        return out

    def forward(self, roi_feats: torch.Tensor):
        b, s, oh, ow, c = roi_feats.shape
        x = roi_feats.reshape(b * s, oh, ow, c)
        f = torch.relu(self.cls_fc1(x.reshape(b * s, -1)))
        f = torch.relu(self.cls_fc2(f))
        cls = self.cls_out(f).reshape(b, s, -1)

        r = x.permute(0, 3, 1, 2)
        r = torch.relu(self.reg_pre1(torch.relu(self.reg_pre0(r))))
        fx = r.amax(dim=2)                            # (BS, C, 7) over y
        fy = r.amax(dim=3)                            # (BS, C, 7) over x
        fx = torch.relu(self.reg_post_x(torch.relu(self.up_x(fx))))
        fy = torch.relu(self.reg_post_y(torch.relu(self.up_y(fy))))
        (l_c, r_c), (l_o, r_o) = self._sides(fx, 'x')
        (t_c, d_c), (t_o, d_o) = self._sides(fy, 'y')
        bucket_cls = torch.cat([l_c, r_c, t_c, d_c], -1).reshape(
            b, s, 4 * SIDE_NUM)
        bucket_off = torch.cat([l_o, r_o, t_o, d_o], -1).reshape(
            b, s, 4 * SIDE_NUM)
        return cls, bucket_cls.float(), bucket_off.float()


def sabl_stage_loss(cls_scores: torch.Tensor, bucket_cls: torch.Tensor,
                    bucket_off: torch.Tensor, sampled: SampledRoIs,
                    gt_bboxes: torch.Tensor, scale_factor: float = 1.7,
                    prefix: str = '') -> Dict[str, torch.Tensor]:
    """One SABL stage's softmax CE over the batch's sampled count, and its
    positives' bucket BCE (x 0.5) and offsets' smooth-L1 (β 0.1) over the
    batch's positive count."""
    w = sampled.label_valid.float()
    ce = softmax_cross_entropy(cls_scores.float(), sampled.labels)
    cls_l = (ce * w).sum()
    with torch.no_grad():
        offs, offw, blabels, bclsw = bbox2bucket(
            sampled.rois, _rows(gt_bboxes, sampled.matched_gt), NUM_BUCKETS,
            scale_factor)
    pos_f = sampled.is_pos.float()[..., None]
    bce = binary_cross_entropy(bucket_cls, blabels, reduction='none')
    bcls_l = (bce * bclsw * pos_f).sum()
    boff_l = smooth_l1_loss(bucket_off, offs, weight=offw * pos_f, beta=0.1,
                            reduction='sum')
    dval = torch.clamp(batch_total(w.sum()), min=1.0)
    dpos = torch.clamp(batch_total(pos_f.sum()), min=1.0)
    return {f'{prefix}loss_cls': cls_l / dval,
            f'{prefix}loss_bbox_cls': 0.5 * bcls_l / dpos,
            f'{prefix}loss_bbox_reg': boff_l / dpos}


def _decode(rois: torch.Tensor, bucket_cls: torch.Tensor,
            bucket_off: torch.Tensor, img_shape: torch.Tensor,
            scale_factor: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bucket decode of (B, S, 4) RoIs clipped to each image, and its
    confidence (B, S)."""
    dec, conf = bucket2bbox(rois, bucket_cls, bucket_off, NUM_BUCKETS,
                            scale_factor)
    return clip_boxes(dec, img_shape[:, None, :].float()), conf


@DETECTORS.register_module()
class SABLFasterRCNN(FPNProposer):
    """`FPNProposer`'s trunk, FPN, RPN and proposals; one SABL stage
    (`sabl_head_0`), or two with `cascade=True`. The JAX module fixes the
    proposal configs, the stages' sample count and the test config; here
    they are fields with its values as defaults (`rpn_proposal_cfg`,
    `rpn_test_cfg`, `num_samples`, `roi_test_cfg`), so that a caller can
    lower the serving threshold or cut a tiny model's proposals."""

    def __init__(self, num_classes: int = 80, backbone_depth: int = 50,
                 backbone_cfg: Any = None, frozen_stages: int = 1,
                 scale_factor: float = 1.7, cascade: bool = False,
                 rpn_proposal_cfg: ProposalConfig = ProposalConfig(
                     nms_pre=4096, max_per_img=1000),
                 rpn_test_cfg: ProposalConfig = ProposalConfig(
                     nms_pre=4096, max_per_img=1000),
                 num_samples: int = 512,
                 roi_test_cfg: RoITestConfig = RoITestConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__(num_classes, backbone_depth, backbone_cfg,
                         frozen_stages=frozen_stages,
                         rpn_proposal_cfg=rpn_proposal_cfg,
                         rpn_test_cfg=rpn_test_cfg, dtype=dtype)
        self.scale_factor = scale_factor
        self.cascade = cascade
        self.num_samples = num_samples
        self.num_stages = 2 if cascade else 1
        for i in range(self.num_stages):
            self.add_module(f'sabl_head_{i}', SABLBBoxHead(
                num_classes=num_classes, dtype=dtype))
        self.roi_test_cfg = roi_test_cfg

    @property
    def bbox_heads(self):
        return [getattr(self, f'sabl_head_{i}')
                for i in range(self.num_stages)]

    def stage_cfg(self, i: int) -> RoITrainConfig:
        """Stage i's assigner and sampler: IoU 0.5 (the cascade's second
        stage 0.6), low-quality matches only without the cascade."""
        thr = (0.5, 0.6)[i] if self.cascade else 0.5
        return RoITrainConfig(pos_iou_thr=thr, neg_iou_thr=thr,
                              min_pos_iou=thr,
                              match_low_quality=not self.cascade,
                              num_samples=self.num_samples,
                              use_sigmoid_cls=False)

    @property
    def roi_train_cfg(self) -> RoITrainConfig:
        return self.stage_cfg(0)

    def loss(self, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             sampler_priorities: Optional[Dict[str, torch.Tensor]] = None
             ) -> Dict[str, torch.Tensor]:
        """The RPN losses, then each stage's on its sampled RoIs (terms
        prefixed 's<i>.' in the cascade)."""
        pri = sampler_priorities or {}
        feats, losses, boxes, box_valid = self._proposals(
            batch, generator, sampler_priorities)
        maps = self.roi_maps(feats)
        for i, head in enumerate(self.bbox_heads):
            with torch.no_grad(), record_function('step/roi_sampling'):
                sampled = sample_rois(
                    boxes, box_valid, batch['gt_bboxes'], batch['gt_labels'],
                    batch['gt_valid'], self.num_classes, self.stage_cfg(i),
                    priorities=pri.get(stage_priority_key(i)),
                    generator=generator)
            with record_function('step/roi_align_fwd'):
                roi_feats = self.roi_extract(maps, sampled.rois,
                                             flatten=False)
            with record_function('step/bbox_head_and_loss'):
                cls_s, bc_s, bo_s = head(roi_feats)
                losses.update(sabl_stage_loss(
                    cls_s, bc_s, bo_s, sampled, batch['gt_bboxes'].float(),
                    self.scale_factor, f's{i}.' if self.cascade else ''))
            if i + 1 < self.num_stages:
                with torch.no_grad():
                    boxes, _ = _decode(sampled.rois, bc_s, bo_s,
                                       batch['img_shape'], self.scale_factor)
                box_valid = sampled.label_valid
        return losses

    @torch.inference_mode()
    def predict(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """Proposals → each stage's head on the boxes (the earlier stages'
        decodes refine them) → the last stage's softmax scores x its
        decode's confidence → class-aware NMS."""
        feats, boxes, box_valid = self._test_proposals(batch)
        maps = self.roi_maps(feats)
        for i, head in enumerate(self.bbox_heads):
            cls_s, bc_s, bo_s = head(self.roi_extract(maps, boxes,
                                                      flatten=False))
            if i + 1 < self.num_stages:
                boxes, _ = _decode(boxes, bc_s, bo_s, batch['img_shape'],
                                   self.scale_factor)
        c = self.num_classes
        probs = torch.softmax(cls_s.float(), -1)[..., :c] * \
            box_valid[..., None]
        dec, conf = _decode(boxes, bc_s, bo_s, batch['img_shape'],
                            self.scale_factor)
        cfg = self.roi_test_cfg
        top, idx = top_scores(probs * conf[..., None], cfg)
        return nms_detections(_rows(dec, idx // c), top, idx % c, cfg)
