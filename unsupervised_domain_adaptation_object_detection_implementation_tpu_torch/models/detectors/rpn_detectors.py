"""The proposal-network family (counterpart of the JAX package's
`models/detectors/rpn_detectors.py`): `RPN`, `FastRCNN`, Guided Anchoring
(`GARetinaNet`, `GARPN`, `GAFasterRCNN`) and Cascade RPN (`CascadeRPN`,
`CRPNFasterRCNN`).

Every level list flattens to one (B, N, ·) tensor, each level NHWC
location-major, the levels in order, with a per-location center, stride
and level id (`_fpn_grid`). Guided anchors are tensors (centers from the
grid, shapes from the net), so the max-IoU assignment runs on them as on
fixed anchors. The adaptive convolutions are the plain-torch deformable
convolution of `ops/deform_conv.py`, as the JAX package's are XLA code.

Proposal detectors (`RPN`, `GARPN`, `CascadeRPN`) return their proposals
as class-0 detections; the two-stage ones feed them to the Shared2FC RoI
head over P2–P5 (`extract_roi_feats_fpn`, the CUDA RoIAlign pair on a
card). `FastRCNN` takes them from `batch['proposals']` /
`batch['proposals_valid']`.

The adaptive convolutions' HWIO kernels (`adapt_conv_w`, `s2_adapt_w`)
are raw parameters at the detector's `dtype`, as the JAX package makes
them: at bf16 they are bf16 parameters, where every conv keeps f32 ones.

The batch contract and the samplers are those of `faster_rcnn.py`:
`sampler_priorities` keys `rpn` (B, N anchors) and `rcnn` (B, G + P).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from ...core.bbox.assigners import max_iou_assign
from ...core.bbox.extra_assigners import center_region_assign
from ...core.bbox.transforms import bbox2delta, clip_boxes, delta2bbox
from ...core.post.nms import NEG_INF, nms, topk_stable
from ...ops.deform_conv import batched_deform_conv2d
from ...parallel.batch import batch_total
from ...utils.registry import DETECTORS, HEADS
from ..backbones.build import build_trunk
from ..dense_heads.anchor_head import (DensePredictConfig,
                                       dense_anchor_predict,
                                       flatten_level_preds)
from ..dense_heads.rpn_head import (ProposalConfig, RPNHead, RPNTrainConfig,
                                    rpn_loss, rpn_proposals)
from ..layers.precision import Conv2d
from ..losses import (binary_cross_entropy, iou_loss, sigmoid_focal_loss,
                      smooth_l1_loss)
from ..necks.build import make_fpn_neck
from ..roi_heads.bbox_head import Shared2FCBBoxHead
from ..roi_heads.standard_roi_head import (RoITestConfig, RoITrainConfig,
                                           bbox_loss, extract_roi_feats_fpn,
                                           roi_head_predict, sample_rois)
from .faster_rcnn import AnchorConfig, cached_grid_anchors
from .faster_rcnn_fpn import ROI_STRIDES, FPNProposer, FPNRPNHead

GA_STDS = (0.07, 0.07, 0.14, 0.14)
LOC_BIAS = -4.595      # the GA heads' location and class logits' bias init


@functools.lru_cache(maxsize=16)
def _fpn_grid_np(strides: Tuple[int, ...], sizes: Tuple[Tuple[int, int], ...]
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    centers, svec, lvec = [], [], []
    for li, (s, (h, w)) in enumerate(zip(strides, sizes)):
        ys = (np.arange(h) + 0.5) * s
        xs = (np.arange(w) + 0.5) * s
        yy, xx = np.meshgrid(ys, xs, indexing='ij')
        centers.append(np.stack([xx.ravel(), yy.ravel()], -1))
        svec.append(np.full(h * w, s, np.float32))
        lvec.append(np.full(h * w, li, np.int64))
    return (np.concatenate(centers).astype(np.float32),
            np.concatenate(svec), np.concatenate(lvec))


def _fpn_grid(strides: Sequence[int], sizes: Sequence[Tuple[int, int]],
              device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flat per-location centers (N, 2) (x, y), strides (N,) and level ids
    (N,) of FPN levels of (h, w) `sizes` at `strides`."""
    return tuple(torch.from_numpy(a).to(device) for a in _fpn_grid_np(
        tuple(strides), tuple(tuple(s) for s in sizes)))


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, D), idx (B, K) → (B, K, D)."""
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _matched(gt: torch.Tensor, assigned: torch.Tensor) -> torch.Tensor:
    """The gt box (B, N, 4) of each prior's assignment (gt 0 where none)."""
    m = (assigned - 1).clamp(0, gt.shape[1] - 1)
    return _rows(gt, m)


def nms_proposals(score: torch.Tensor, reg: torch.Tensor,
                  anchors: torch.Tensor, img_shape: torch.Tensor,
                  cfg: ProposalConfig,
                  stds: Tuple[float, ...] = (1., 1., 1., 1.)):
    """The GA and Cascade RPN proposal path: the top `nms_pre` of the (B, N)
    logits (NEG_INF where filtered; ties to the lower index), decoded from
    their (B, N, 4) anchors at `stds`, clipped, NMS, the top
    `max_per_img` → (boxes (B, P, 4) zeroed past the valid rows, their
    logits (B, P), valid (B, P)). No size filter, as in the JAX package."""
    k = min(cfg.nms_pre, score.shape[-1])
    top, idx = topk_stable(score, k)
    boxes = delta2bbox(_rows(anchors, idx), _rows(reg, idx), stds=stds)
    boxes = clip_boxes(boxes, img_shape[:, None, :].to(boxes.dtype))
    keep, _ = nms(boxes, top, cfg.nms_iou_threshold, cfg.nms_tile)
    kept = torch.where(keep, top, top.new_tensor(NEG_INF))
    p = min(cfg.max_per_img, k)
    sc, sel = topk_stable(kept, p)
    valid = sc > NEG_INF / 2
    return _rows(boxes, sel) * valid[..., None], sc, valid


def _proposal_dets(boxes, sc, valid) -> Dict[str, torch.Tensor]:
    """Proposals as class-0 detections, scores the logits' sigmoid."""
    scores = torch.where(valid, torch.sigmoid(sc), sc.new_zeros(()))
    return dict(dets=torch.cat([boxes, scores[..., None]], -1),
                labels=torch.zeros_like(valid, dtype=torch.int64),
                valid=valid)


def _fpn_trunk(backbone_cfg, backbone_depth, frozen_stages, dtype):
    return build_trunk(backbone_cfg, depth=backbone_depth,
                       strides=(1, 2, 2, 2), dilations=(1, 1, 1, 1),
                       out_indices=(0, 1, 2, 3), frozen_stages=frozen_stages,
                       dtype=dtype)


def _extract_feat(module, image: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """image (B, H, W, 3) → the neck's (B, C, H_l, W_l) levels at `dtype`."""
    return module.neck(module.backbone(
        image.to(module.dtype).permute(0, 3, 1, 2)))


def _box_roi_feats(maps, rois):
    """7x7 flat RoI features over the NHWC levels P2–P5."""
    return extract_roi_feats_fpn(maps, rois, ROI_STRIDES, flatten=True)


class _Forward:
    """`forward(batch, train)`: the loss dict with `train`, else predict."""

    def forward(self, batch: Dict[str, torch.Tensor], train: bool = True,
                generator: Optional[torch.Generator] = None,
                sampler_priorities: Optional[Dict[str, torch.Tensor]] = None):
        if train:
            return self.loss(batch, generator, sampler_priorities)
        return self.predict(batch)


class _RoIHeadMixin:
    """The Shared2FC box head on the (B, P) proposals: the sampled RoIs'
    losses and `roi_head_predict`."""

    def _box_losses(self, feats, proposals, prop_valid, batch, generator,
                    sampler_priorities) -> Dict[str, torch.Tensor]:
        pri = sampler_priorities or {}
        with torch.no_grad(), record_function('step/roi_sampling'):
            sampled = sample_rois(
                proposals, prop_valid, batch['gt_bboxes'],
                batch['gt_labels'], batch['gt_valid'], self.num_classes,
                self.roi_train_cfg, priorities=pri.get('rcnn'),
                generator=generator)
        with record_function('step/roi_align_fwd'):
            roi_feats = _box_roi_feats(FPNProposer.roi_maps(feats),
                                       sampled.rois)
        with record_function('step/bbox_head_and_loss'):
            cls_s, reg_s, _ = self.bbox_head(roi_feats)
            return bbox_loss(cls_s, reg_s, sampled, self.num_classes,
                             self.roi_train_cfg)

    def _box_predict(self, feats, proposals, prop_valid, img_shape):
        return roi_head_predict(
            self.bbox_head, FPNProposer.roi_maps(feats), proposals,
            prop_valid, img_shape, self.num_classes,
            reg_class_agnostic=False,
            target_stds=self.roi_train_cfg.target_stds,
            use_sigmoid_cls=self.roi_train_cfg.use_sigmoid_cls,
            cfg=self.roi_test_cfg, roi_extractor=_box_roi_feats)


@DETECTORS.register_module()
class RPN(_Forward, nn.Module):
    """The standalone RPN: its proposals are the detections (class 0),
    for proposal recall (`metric='recall'`). FPN levels P2–P6 with three
    anchors a location, or with `c4` the 3-stage trunk's stride-16 C4 map
    with the 15-anchor grid."""

    def __init__(self, num_classes: int = 1, backbone_depth: int = 50,
                 backbone_cfg: Any = None, frozen_stages: int = 1,
                 c4: bool = False,
                 rpn_strides: Tuple[int, ...] = (4, 8, 16, 32, 64),
                 rpn_train_cfg: RPNTrainConfig = RPNTrainConfig(),
                 test_cfg: ProposalConfig = ProposalConfig(
                     nms_pre=4096, max_per_img=1000),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.c4 = c4
        self.rpn_strides = tuple(rpn_strides)
        self.rpn_train_cfg = rpn_train_cfg
        self.test_cfg = test_cfg
        self.dtype = dtype
        if c4:
            self.backbone = build_trunk(
                backbone_cfg, depth=backbone_depth, num_stages=3,
                strides=(1, 2, 2), dilations=(1, 1, 1), out_indices=(2,),
                frozen_stages=frozen_stages, dtype=dtype)
            self.rpn_head = RPNHead(
                in_channels=self.backbone.stage_channels()[-1],
                feat_channels=1024, num_anchors=15, dtype=dtype)
            return
        self.backbone = _fpn_trunk(backbone_cfg, backbone_depth,
                                   frozen_stages, dtype)
        self.neck = make_fpn_neck('FPN',
                                  in_channels=self.backbone.stage_channels(),
                                  out_channels=256, num_outs=5, dtype=dtype)
        self.rpn_head = FPNRPNHead(in_channels=256, dtype=dtype)

    def _flat(self, image: torch.Tensor):
        """→ cls (B, N, 1, 1), reg (B, N, 1, 4), anchors (N, 4)."""
        x = image.to(self.dtype).permute(0, 3, 1, 2)
        if self.c4:
            (feat,) = self.backbone(x)
            cls, reg = self.rpn_head(feat)
            anchors = AnchorConfig().grid_anchors(feat.shape[-2],
                                                  feat.shape[-1])
        else:
            feats = self.neck(self.backbone(x))
            cls_lv, reg_lv = self.rpn_head(feats)
            anchors = cached_grid_anchors(
                self.rpn_strides, (0.5, 1.0, 2.0), (8,),
                tuple((f.shape[-2], f.shape[-1]) for f in feats))
            cls = flatten_level_preds(cls_lv, 1)
            reg = flatten_level_preds(reg_lv, 4)
        b = cls.shape[0]
        return (cls.reshape(b, -1, 1, 1), reg.reshape(b, -1, 1, 4),
                torch.tensor(anchors, device=image.device))

    def loss(self, batch, generator=None, sampler_priorities=None):
        with record_function('step/trunk_neck_rpn_head'):
            cls, reg, anchors = self._flat(batch['image'].float())
        with record_function('step/rpn_loss'):
            return rpn_loss(cls, reg, anchors, batch['gt_bboxes'],
                            batch['gt_valid'], batch['img_shape'],
                            self.rpn_train_cfg,
                            priorities=(sampler_priorities or {}).get('rpn'),
                            generator=generator)

    @torch.inference_mode()
    def predict(self, batch):
        cls, reg, anchors = self._flat(batch['image'].float())
        boxes, scores, valid = rpn_proposals(cls, reg, anchors,
                                             batch['img_shape'],
                                             self.test_cfg)
        return dict(dets=torch.cat([boxes, scores[..., None]], -1),
                    labels=torch.zeros_like(valid, dtype=torch.int64),
                    valid=valid)


@DETECTORS.register_module()
class FastRCNN(_RoIHeadMixin, _Forward, nn.Module):
    """Fast R-CNN: the Shared2FC RoI head over precomputed proposals,
    `batch['proposals']` (B, P, 4) with `batch['proposals_valid']` (B, P),
    e.g. a standalone RPN's. `neck_type='BFP'` raises: only the FPN neck is
    ported."""

    def __init__(self, num_classes: int = 80, backbone_depth: int = 50,
                 backbone_cfg: Any = None, frozen_stages: int = 1,
                 neck_type: str = 'FPN',
                 roi_train_cfg: RoITrainConfig = RoITrainConfig(
                     use_sigmoid_cls=False),
                 roi_test_cfg: RoITestConfig = RoITestConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.roi_train_cfg = roi_train_cfg
        self.roi_test_cfg = roi_test_cfg
        self.dtype = dtype
        self.backbone = _fpn_trunk(backbone_cfg, backbone_depth,
                                   frozen_stages, dtype)
        self.neck = make_fpn_neck(neck_type,
                                  in_channels=self.backbone.stage_channels(),
                                  out_channels=256, num_outs=5, dtype=dtype)
        self.bbox_head = Shared2FCBBoxHead(num_classes=num_classes,
                                           in_channels=256, dtype=dtype)

    @staticmethod
    def _proposals(batch):
        if 'proposals' not in batch:
            raise KeyError(
                "'proposals': FastRCNN reads precomputed proposals from "
                "batch['proposals'] / batch['proposals_valid']; "
                'PackDetInputs does not carry what LoadProposals loads (as in '
                'the JAX package), so a batch of the config pipeline has none')
        return (batch['proposals'].float().contiguous(),
                batch['proposals_valid'])

    def loss(self, batch, generator=None, sampler_priorities=None):
        proposals, prop_valid = self._proposals(batch)
        with record_function('step/trunk_and_neck'):
            feats = _extract_feat(self, batch['image'].float())
        return self._box_losses(feats, proposals, prop_valid, batch,
                                generator, sampler_priorities)

    @torch.inference_mode()
    def predict(self, batch):
        proposals, prop_valid = self._proposals(batch)
        feats = _extract_feat(self, batch['image'].float())
        return self._box_predict(feats, proposals, prop_valid,
                                 batch['img_shape'])


@HEADS.register_module()
class GuidedAnchorHead(nn.Module):
    """The Guided Anchoring head, shared by the levels: `stacked_convs` 3x3
    convs, then per level the location logit (1), the anchor shape (dw,
    dh), the offsets of a 3x3 deformable conv from the detached shape
    (`conv_offset`, zero-initialised), that conv (`adapt_conv_w`, a raw
    HWIO parameter at `dtype`) with a ReLU, and the class (`out_channels`)
    and box (4) outputs on the adapted map."""

    def __init__(self, out_channels: int = 1, feat_channels: int = 256,
                 stacked_convs: int = 0, in_channels: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stacked_convs = stacked_convs
        conv = functools.partial(Conv2d, compute_dtype=dtype)
        for i in range(stacked_convs):
            self.add_module(f'pre_conv{i}', conv(
                in_channels if i == 0 else feat_channels, feat_channels, 3,
                padding=1))
        self.conv_loc = conv(feat_channels, 1, 1)
        self.conv_shape = conv(feat_channels, 2, 1)
        self.conv_offset = conv(2, 2 * 9, 1, bias=False)
        self.adapt_conv_w = nn.Parameter(torch.empty(
            3, 3, feat_channels, feat_channels, dtype=dtype))
        self.conv_cls = conv(feat_channels, out_channels, 1)
        self.conv_reg = conv(feat_channels, 4, 1)

    def forward(self, feats: Sequence[torch.Tensor]):
        """feats: (B, C, H_l, W_l) levels → per level NHWC float32 loc
        (B, H, W, 1), shape (B, H, W, 2), cls (B, H, W, out) and reg
        (B, H, W, 4)."""
        loc_s, shape_s, cls_s, reg_s = [], [], [], []
        for f in feats:
            with record_function('step/ga_head'):
                t = f
                for i in range(self.stacked_convs):
                    t = torch.relu(getattr(self, f'pre_conv{i}')(t))
                loc_s.append(_nhwc(self.conv_loc(t).float()))
                sh = self.conv_shape(t).float()
                shape_s.append(_nhwc(sh))
                off = _nhwc(self.conv_offset(sh.detach().to(t.dtype)))
            with record_function('step/deform_conv'):
                a = torch.relu(batched_deform_conv2d(_nhwc(t), off,
                                                     self.adapt_conv_w))
            with record_function('step/ga_head'):
                a = a.permute(0, 3, 1, 2)
                cls_s.append(_nhwc(self.conv_cls(a).float()))
                reg_s.append(_nhwc(self.conv_reg(a).float()))
        return tuple(loc_s), tuple(shape_s), tuple(cls_s), tuple(reg_s)


class _GABase(_Forward, nn.Module):
    """Guided Anchoring over the FPN: guided anchors centered on the grid
    with (w, h) = stride · `octave_base` · exp(clip(shape, ±4)), the
    location focal loss and the shape IoU loss."""

    def __init__(self, num_classes: int = 80, backbone_depth: int = 50,
                 backbone_cfg: Any = None, frozen_stages: int = 1,
                 strides: Tuple[int, ...] = (8, 16, 32, 64, 128),
                 octave_base: float = 8.0, loc_filter_thr: float = 0.01,
                 center_ratio: float = 0.2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.strides = tuple(strides)
        self.octave_base = octave_base
        self.loc_filter_thr = loc_filter_thr
        self.center_ratio = center_ratio
        self.dtype = dtype
        self.backbone = _fpn_trunk(backbone_cfg, backbone_depth,
                                   frozen_stages, dtype)
        start = 1 if self.strides[0] == 8 else 0
        self.neck = make_fpn_neck(
            'FPN', in_channels=self.backbone.stage_channels(),
            out_channels=256, num_outs=5, start_level=start,
            add_extra_convs='on_input' if start else False, dtype=dtype)
        out = self.ga_out_channels()
        self.ga_head = GuidedAnchorHead(
            out_channels=out, stacked_convs=4 if out > 1 else 0, dtype=dtype)

    def ga_out_channels(self) -> int:
        raise NotImplementedError

    def _flat(self, image: torch.Tensor):
        """→ (loc (B, N), shape (B, N, 2), cls (B, N, out), reg (B, N, 4),
        guided anchors (B, N, 4), centers (N, 2), levels (N,), the neck's
        levels)."""
        with record_function('step/trunk_and_neck'):
            feats = _extract_feat(self, image)
        loc_lv, shape_lv, cls_lv, reg_lv = self.ga_head(feats)
        sizes = [(f.shape[-2], f.shape[-1]) for f in feats]
        centers, strides, levels = _fpn_grid(self.strides, sizes,
                                             image.device)
        loc = flatten_level_preds(loc_lv, 1)[..., 0]
        shape = flatten_level_preds(shape_lv, 2)
        cls = flatten_level_preds(cls_lv, self.ga_out_channels())
        reg = flatten_level_preds(reg_lv, 4)
        base = (strides * self.octave_base)[None, :, None]
        wh = base * torch.exp(shape.clamp(-4.0, 4.0))
        anchors = torch.cat([centers[None] - wh / 2, centers[None] + wh / 2],
                            -1)
        return loc, shape, cls, reg, anchors, centers, levels, feats

    def _ga_losses(self, loc, anchors, centers, levels, batch):
        """The location focal loss (label 0 the object at the gt's center
        region on its level, 1 background) and the shape IoU loss of the
        positives' guided anchors against their smallest-area gt, both over
        the positive count."""
        gt, gtv = batch['gt_bboxes'].float(), batch['gt_valid']
        gw = gt[..., 2] - gt[..., 0]
        gh = gt[..., 3] - gt[..., 1]
        scale = torch.sqrt(torch.clamp(gw * gh, min=1e-6))
        gl = torch.clamp(torch.round(torch.log2(
            scale / (self.strides[0] * self.octave_base))),
            0, len(self.strides) - 1)
        ctr = (gt[..., :2] + gt[..., 2:]) / 2
        half = torch.stack([gw, gh], -1) / 2 * self.center_ratio
        lo, hi = ctr - half, ctr + half
        cx, cy = centers[:, 0], centers[:, 1]
        inside = ((cx >= lo[..., 0:1]) & (cx <= hi[..., 0:1])
                  & (cy >= lo[..., 1:2]) & (cy <= hi[..., 1:2]))
        lvl_ok = levels.to(gl.dtype) == gl[..., None]
        pos_mat = inside & lvl_ok & gtv[..., None]              # (B, G, N)
        is_pos = pos_mat.any(dim=1)
        loc_l = sigmoid_focal_loss(loc[..., None], (~is_pos).long(),
                                   reduction='sum')
        inf = gw.new_tensor(float('inf'))
        area = torch.where(gtv, gw * gh, inf)
        key = torch.where(pos_mat, area[..., None], inf)
        best = torch.argmin(key, dim=1)
        shape_l = iou_loss(anchors, _rows(gt, best),
                           weight=is_pos.to(anchors.dtype), reduction='sum')
        denom = torch.clamp(batch_total(is_pos.sum().to(loc_l.dtype)),
                            min=1.0)
        return dict(loss_loc=loc_l / denom, loss_shape=shape_l / denom)

    def _rpn_losses(self, cls, reg, anchors, batch):
        """GA-RPN's objectness BCE over the assigned guided anchors and its
        smooth-L1 over the positives (max-IoU 0.7 / 0.3 / 0.3)."""
        gt, gtv = batch['gt_bboxes'].float(), batch['gt_valid']
        a = max_iou_assign(anchors, gt, gtv, None, pos_iou_thr=0.7,
                           neg_iou_thr=0.3, min_pos_iou=0.3)
        pos = a.assigned_gt_inds > 0
        chosen = pos | (a.assigned_gt_inds == 0)
        cls_l = binary_cross_entropy(cls[..., 0], pos.float(),
                                     weight=chosen.float(), reduction='sum')
        tgt = bbox2delta(anchors, _matched(gt, a.assigned_gt_inds),
                         stds=GA_STDS)
        reg_l = smooth_l1_loss(reg, tgt, weight=pos[..., None].float(),
                               beta=1.0, reduction='sum')
        return dict(
            loss_rpn_cls=cls_l / torch.clamp(batch_total(chosen.sum().float()),
                                             min=1.0),
            loss_rpn_bbox=reg_l / torch.clamp(batch_total(pos.sum().float()),
                                              min=1.0))

    def _loc_filtered(self, loc, score):
        """`score` at NEG_INF where the location probability is under
        `loc_filter_thr` (`loc` broadcast over a trailing class dim)."""
        keep = torch.sigmoid(loc) >= self.loc_filter_thr
        if score.dim() > keep.dim():
            keep = keep[..., None]
        return torch.where(keep, score, score.new_tensor(NEG_INF))


@DETECTORS.register_module()
class GARetinaNet(_GABase):
    """GA-RetinaNet: four stacked 3x3 convs, a class per output channel,
    focal loss over max-IoU (0.5 / 0.4 / 0.0) assigned guided anchors,
    smooth-L1 (β 1/9) on the positives, `dense_anchor_predict` on the
    location-filtered anchors."""

    def __init__(self, *args,
                 test_cfg: DensePredictConfig = DensePredictConfig(),
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.test_cfg = test_cfg

    def ga_out_channels(self) -> int:
        return self.num_classes

    def _retina_losses(self, cls, reg, anchors, batch):
        """The focal loss over max-IoU (0.5 / 0.4 / 0.0) assigned guided
        anchors and smooth-L1 (β 1/9) on the positives, both over the
        batch's positive count."""
        anchors = anchors.detach()
        gt, gtv = batch['gt_bboxes'].float(), batch['gt_valid']
        a = max_iou_assign(anchors, gt, gtv, batch['gt_labels'],
                           pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0)
        pos = a.assigned_gt_inds > 0
        labels = torch.where(pos, a.labels,
                             torch.full_like(a.labels, self.num_classes))
        cls_l = sigmoid_focal_loss(cls, labels, reduction='sum')
        tgt = bbox2delta(anchors, _matched(gt, a.assigned_gt_inds),
                         stds=GA_STDS)
        reg_l = smooth_l1_loss(reg, tgt, weight=pos[..., None].float(),
                               beta=1.0 / 9.0, reduction='sum')
        denom = torch.clamp(batch_total(pos.sum().float()), min=1.0)
        return dict(loss_cls=cls_l / denom, loss_bbox=reg_l / denom)

    def loss(self, batch, generator=None, sampler_priorities=None):
        loc, _, cls, reg, anchors, centers, levels, _ = self._flat(
            batch['image'].float())
        with record_function('step/ga_loss'):
            losses = self._ga_losses(loc, anchors, centers, levels, batch)
            losses.update(self._retina_losses(cls, reg, anchors, batch))
        return losses

    @torch.inference_mode()
    def predict(self, batch):
        loc, _, cls, reg, anchors, *_ = self._flat(batch['image'].float())
        return dense_anchor_predict(
            self._loc_filtered(loc, cls), reg, anchors, batch['img_shape'],
            self.num_classes, self.test_cfg._replace(target_stds=GA_STDS))


@DETECTORS.register_module()
class GARPN(_GABase):
    """GA-RPN: class-agnostic guided anchoring; its proposals are the
    detections (class 0), as `RPN`'s."""

    def __init__(self, *args, strides: Tuple[int, ...] = (4, 8, 16, 32, 64),
                 test_cfg: ProposalConfig = ProposalConfig(
                     nms_pre=4096, max_per_img=1000),
                 **kwargs):
        super().__init__(*args, strides=strides, **kwargs)
        self.test_cfg = test_cfg

    def ga_out_channels(self) -> int:
        return 1

    def _rpn_step(self, batch):
        """(losses, the neck's levels, the detached loc, cls, reg, anchors)."""
        loc, _, cls, reg, anchors, centers, levels, feats = self._flat(
            batch['image'].float())
        with record_function('step/ga_loss'):
            losses = self._ga_losses(loc, anchors, centers, levels, batch)
            losses.update(self._rpn_losses(cls, reg, anchors.detach(),
                                           batch))
        return losses, feats, (loc.detach(), cls.detach(), reg.detach(),
                               anchors.detach())

    def loss(self, batch, generator=None, sampler_priorities=None):
        return self._rpn_step(batch)[0]

    def _ga_proposals(self, loc, cls, reg, anchors, img_shape,
                      cfg: ProposalConfig):
        return nms_proposals(self._loc_filtered(loc, cls[..., 0]), reg,
                             anchors, img_shape, cfg, GA_STDS)

    @torch.inference_mode()
    def predict(self, batch):
        loc, _, cls, reg, anchors, *_ = self._flat(batch['image'].float())
        return _proposal_dets(*self._ga_proposals(
            loc, cls, reg, anchors, batch['img_shape'], self.test_cfg))


@DETECTORS.register_module()
class GAFasterRCNN(_RoIHeadMixin, GARPN):
    """GA-Faster R-CNN: GA-RPN proposals (`rpn_proposal_cfg` to train,
    GA-RPN's `test_cfg` to serve) into the Shared2FC RoI head. The trunk
    and neck run once a step: the JAX package runs them twice
    (`GAFasterRCNN.loss`), whose gradient is the sum of the two
    cotangents, the same one within rounding."""

    def __init__(self, *args, num_classes: int = 80,
                 rpn_proposal_cfg: ProposalConfig = ProposalConfig(
                     nms_pre=2048, max_per_img=300),
                 roi_train_cfg: RoITrainConfig = RoITrainConfig(
                     use_sigmoid_cls=False),
                 roi_test_cfg: RoITestConfig = RoITestConfig(),
                 **kwargs):
        super().__init__(*args, num_classes=num_classes, **kwargs)
        self.rpn_proposal_cfg = rpn_proposal_cfg
        self.roi_train_cfg = roi_train_cfg
        self.roi_test_cfg = roi_test_cfg
        self.bbox_head = Shared2FCBBoxHead(
            num_classes=num_classes, in_channels=256, dtype=self.dtype)

    def loss(self, batch, generator=None, sampler_priorities=None):
        losses, feats, (loc, cls, reg, anchors) = self._rpn_step(batch)
        with torch.no_grad(), record_function('step/proposals'):
            proposals, _, prop_valid = self._ga_proposals(
                loc, cls, reg, anchors, batch['img_shape'],
                self.rpn_proposal_cfg)
        losses.update(self._box_losses(feats, proposals, prop_valid, batch,
                                       generator, sampler_priorities))
        return losses

    @torch.inference_mode()
    def predict(self, batch):
        loc, _, cls, reg, anchors, _, _, feats = self._flat(
            batch['image'].float())
        proposals, _, prop_valid = self._ga_proposals(
            loc, cls, reg, anchors, batch['img_shape'], self.test_cfg)
        return self._box_predict(feats, proposals, prop_valid,
                                 batch['img_shape'])


@DETECTORS.register_module()
class CascadeRPN(_Forward, nn.Module):
    """Cascade RPN: stage 1 regresses one square anchor a location
    (stride · `anchor_scale`), trained on center-region assignment; its
    refined boxes (decoded at the default stds) are stage 2's anchors, and
    stage 2's adaptive 3x3 conv takes offsets from the detached stage-1
    regression, then classifies and regresses, trained on max-IoU (0.7 /
    0.7 / 0.3) assignment of the refined anchors."""

    def __init__(self, num_classes: int = 1, backbone_depth: int = 50,
                 backbone_cfg: Any = None, frozen_stages: int = 1,
                 strides: Tuple[int, ...] = (4, 8, 16, 32, 64),
                 anchor_scale: float = 8.0,
                 test_cfg: ProposalConfig = ProposalConfig(
                     nms_pre=4096, max_per_img=1000),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.strides = tuple(strides)
        self.anchor_scale = anchor_scale
        self.test_cfg = test_cfg
        self.dtype = dtype
        self.backbone = _fpn_trunk(backbone_cfg, backbone_depth,
                                   frozen_stages, dtype)
        self.neck = make_fpn_neck('FPN',
                                  in_channels=self.backbone.stage_channels(),
                                  out_channels=256, num_outs=5, dtype=dtype)
        conv = functools.partial(Conv2d, compute_dtype=dtype)
        self.s1_conv = conv(256, 256, 3, padding=1)
        self.s1_reg = conv(256, 4, 1)
        self.s2_offset = conv(4, 2 * 9, 1, bias=False)
        self.s2_adapt_w = nn.Parameter(torch.empty(3, 3, 256, 256,
                                                   dtype=dtype))
        self.s2_cls = conv(256, 1, 1)
        self.s2_reg = conv(256, 4, 1)

    def _stages(self, image: torch.Tensor):
        """→ (reg1 (B, N, 4), cls2 (B, N), reg2 (B, N, 4), anchors0 (N, 4),
        anchors1 (B, N, 4), the neck's levels)."""
        with record_function('step/trunk_and_neck'):
            feats = _extract_feat(self, image)
        sizes = [(f.shape[-2], f.shape[-1]) for f in feats]
        centers, strides, _ = _fpn_grid(self.strides, sizes, image.device)
        base = strides * self.anchor_scale
        anchors0 = torch.cat([centers - base[:, None] / 2,
                              centers + base[:, None] / 2], -1)
        reg1_lv, cls2_lv, reg2_lv = [], [], []
        for f in feats:
            with record_function('step/crpn_head'):
                t1 = torch.relu(self.s1_conv(f))
                r1 = self.s1_reg(t1).float()
                reg1_lv.append(_nhwc(r1))
                off = _nhwc(self.s2_offset(r1.detach().to(t1.dtype)))
            with record_function('step/deform_conv'):
                t2 = torch.relu(batched_deform_conv2d(_nhwc(t1), off,
                                                      self.s2_adapt_w))
            with record_function('step/crpn_head'):
                t2 = t2.permute(0, 3, 1, 2)
                cls2_lv.append(_nhwc(self.s2_cls(t2).float()))
                reg2_lv.append(_nhwc(self.s2_reg(t2).float()))
        reg1 = flatten_level_preds(reg1_lv, 4)
        cls2 = flatten_level_preds(cls2_lv, 1)[..., 0]
        reg2 = flatten_level_preds(reg2_lv, 4)
        anchors1 = delta2bbox(anchors0, reg1)
        return reg1, cls2, reg2, anchors0, anchors1, feats

    def _crpn_losses(self, reg1, cls2, reg2, anchors0, anchors1, batch,
                     weight: float = 1.0) -> Dict[str, torch.Tensor]:
        gt, gtv = batch['gt_bboxes'].float(), batch['gt_valid']
        a1 = center_region_assign(anchors0, gt, gtv, None, pos_scale=0.2,
                                  neg_scale=0.2)
        pos1 = a1.assigned_gt_inds > 0
        t1 = bbox2delta(anchors0, _matched(gt, a1.assigned_gt_inds))
        l1 = smooth_l1_loss(reg1, t1, weight=pos1[..., None].float(),
                            beta=1.0, reduction='sum')
        anch = anchors1.detach()
        a2 = max_iou_assign(anch, gt, gtv, None, pos_iou_thr=0.7,
                            neg_iou_thr=0.7, min_pos_iou=0.3)
        pos2 = a2.assigned_gt_inds > 0
        chosen = pos2 | (a2.assigned_gt_inds == 0)
        cls_l = binary_cross_entropy(cls2, pos2.float(),
                                     weight=chosen.float(), reduction='sum')
        t2 = bbox2delta(anch, _matched(gt, a2.assigned_gt_inds))
        l2 = smooth_l1_loss(reg2, t2, weight=pos2[..., None].float(),
                            beta=1.0, reduction='sum')
        denom = torch.clamp(batch_total((pos1.sum() + pos2.sum()).float()),
                            min=1.0)
        return dict(
            loss_rpn_reg_s1=weight * l1 / denom,
            loss_rpn_cls=weight * cls_l / torch.clamp(
                batch_total(chosen.sum().float()), min=1.0),
            loss_rpn_reg_s2=weight * l2 / denom)

    def loss(self, batch, generator=None, sampler_priorities=None):
        reg1, cls2, reg2, anchors0, anchors1, _ = self._stages(
            batch['image'].float())
        with record_function('step/crpn_loss'):
            return self._crpn_losses(reg1, cls2, reg2, anchors0, anchors1,
                                     batch)

    @torch.inference_mode()
    def predict(self, batch):
        _, cls2, reg2, _, anchors1, _ = self._stages(batch['image'].float())
        return _proposal_dets(*nms_proposals(
            cls2, reg2, anchors1, batch['img_shape'], self.test_cfg))


@DETECTORS.register_module()
class CRPNFasterRCNN(_RoIHeadMixin, CascadeRPN):
    """Cascade RPN inside Faster R-CNN: its losses weighted by
    `rpn_weight`, its stage-2 proposals (NMS 0.8, at most 300) into the
    Shared2FC RoI head, sampled at IoU 0.65 with stds (0.04, 0.04, 0.08,
    0.08)."""

    def __init__(self, *args, num_classes: int = 80, rpn_weight: float = 0.7,
                 rpn_proposal_cfg: ProposalConfig = ProposalConfig(
                     nms_pre=2048, max_per_img=300, nms_iou_threshold=0.8),
                 test_cfg: ProposalConfig = ProposalConfig(
                     nms_pre=2048, max_per_img=300, nms_iou_threshold=0.8),
                 roi_train_cfg: RoITrainConfig = RoITrainConfig(
                     pos_iou_thr=0.65, neg_iou_thr=0.65, min_pos_iou=0.65,
                     num_samples=256, use_sigmoid_cls=False,
                     target_stds=(0.04, 0.04, 0.08, 0.08)),
                 roi_test_cfg: RoITestConfig = RoITestConfig(score_thr=1e-3),
                 **kwargs):
        super().__init__(*args, num_classes=num_classes, test_cfg=test_cfg,
                         **kwargs)
        self.rpn_weight = rpn_weight
        self.rpn_proposal_cfg = rpn_proposal_cfg
        self.roi_train_cfg = roi_train_cfg
        self.roi_test_cfg = roi_test_cfg
        self.bbox_head = Shared2FCBBoxHead(num_classes=num_classes,
                                           in_channels=256, dtype=self.dtype)

    def loss(self, batch, generator=None, sampler_priorities=None):
        reg1, cls2, reg2, anchors0, anchors1, feats = self._stages(
            batch['image'].float())
        with record_function('step/crpn_loss'):
            losses = self._crpn_losses(reg1, cls2, reg2, anchors0, anchors1,
                                       batch, self.rpn_weight)
        with torch.no_grad(), record_function('step/proposals'):
            proposals, _, prop_valid = nms_proposals(
                cls2.detach(), reg2.detach(), anchors1.detach(),
                batch['img_shape'], self.rpn_proposal_cfg)
        losses.update(self._box_losses(feats, proposals, prop_valid, batch,
                                       generator, sampler_priorities))
        return losses

    @torch.inference_mode()
    def predict(self, batch):
        _, cls2, reg2, _, anchors1, feats = self._stages(
            batch['image'].float())
        proposals, _, prop_valid = nms_proposals(
            cls2, reg2, anchors1, batch['img_shape'], self.test_cfg)
        return self._box_predict(feats, proposals, prop_valid,
                                 batch['img_shape'])


def init_adaptive_heads_(model: nn.Module, generator: torch.Generator,
                         heads: str = 'mmdet') -> None:
    """The JAX package's init of the GA and Cascade RPN layers that differ
    from the lecun default: the adaptive convs' HWIO kernels ~ N(0, 2 /
    fan_in) (flax's `he_normal` scale), the offset convs zero, and the GA
    location and class logits' bias −4.595. With `heads='mmdet'` (the
    default, as for the RPN and box heads) their prediction convs (GA's
    location, shape, class and box convs; Cascade RPN's stage convs and
    outputs) are drawn first at mmdet's std 0.01, as mmdet's
    `GuidedAnchorHead` and Cascade RPN heads draw them: at the lecun scale
    a full-width GA-RPN step at the COCO config's lr 0.02 diverges within
    two steps."""
    for m in model.modules():
        if isinstance(m, GuidedAnchorHead):
            adapt, offset = m.adapt_conv_w, m.conv_offset
            preds = (m.conv_loc, m.conv_shape, m.conv_cls, m.conv_reg)
        elif isinstance(m, CascadeRPN):
            adapt, offset = m.s2_adapt_w, m.s2_offset
            preds = (m.s1_conv, m.s1_reg, m.s2_cls, m.s2_reg)
        else:
            continue
        for conv in preds if heads == 'mmdet' else ():
            conv.weight.normal_(0.0, 0.01, generator=generator)
        if isinstance(m, GuidedAnchorHead):
            m.conv_loc.bias.fill_(LOC_BIAS)
            m.conv_cls.bias.fill_(LOC_BIAS)
        fan_in = adapt[..., 0].numel()
        adapt.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)
        offset.weight.zero_()
