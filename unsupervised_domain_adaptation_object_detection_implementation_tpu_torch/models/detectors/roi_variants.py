"""Two-stage RoI-head variants (counterpart of the JAX package's
`models/detectors/roi_variants.py`): Mask Scoring R-CNN, Double-Head
R-CNN, Dynamic R-CNN, Grid R-CNN and PointRend.

Each is `FasterRCNNFPN` (the mask variants `MaskRCNN`) with its own RoI
head and loss: they reuse its sampling step (`_sample`), box losses
(`_box_losses`) and serving (`_detect`), and the mask variants Mask R-CNN's
mask branch (`_mask_losses`), and add their heads.
The RoI features come from the level-assigned extractor, or from GRoIE's
all-level sum with `roi_extractor_type='groie'`; either launches the
RoIAlign kernel pair on a card (`ops/roi_align.py`). A step draws the
samplers' priorities as the other FPN families do: the RPN's ('rpn'), then
the RoI sampler's ('rcnn').

What each copies of the JAX package, beside mmdet's heads:

- `DoubleHeadRCNN`: the conv branch (1x1 in, four residual bottlenecks,
  GAP) regresses, the fc branch over the (y, x, C) flattened 7x7 features
  classifies; both loss terms x2.
- `DynamicRCNN`: the IoU threshold is the `iou_topk`-th best proposal IoU
  of each image, averaged over the batch and clipped to [0.35, 0.75],
  applied by demoting the positives of the base-0.5 sampling below it; the
  SmoothL1 beta is the (`beta_topk` x B)-th smallest mean error over the
  positives (1.0 where there are fewer, clipped to [0.01, 1]), with its
  gradient, as JAX takes no stop-gradient there.
- `GridRCNN`: 9-point heatmaps at 56x56 in the 2x-expanded RoI frame,
  radius-1 targets without mmdet's `w <= grid_size` gate, BCE x15, no box
  regression loss (the box head's regressor gets no gradient: weight decay
  alone moves it); the head's GroupNorm takes its statistics over every
  RoI of an image (flax's reduction axes). Serving scores the proposals
  themselves (`with_reg=False`) and decodes the boxes from the grid
  argmaxes, both through the level-assigned extractor whatever
  `roi_extractor_type` says.
- `MaskScoringRCNN`: Mask R-CNN's branch plus a MaskIoU head fed the
  sigmoid of the own-class mask logits without a stop-gradient (so
  `loss_mask_iou` trains the mask head; only the binarised target is
  stopped), downsampled 28 → 14 with JAX's nearest rule; the test score is
  the class score x the clipped predicted mask IoU.
- `PointRend`: the point loss at the `num_points` most uncertain points
  of each RoI's own-class coarse mask (selected by a stable sort, JAX's
  top-k order on ties), on P2 features and the coarse logits sampled
  there; serving scatters the refined logits back at those points.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.profiler import record_function

from ...core.bbox.iou import bbox_overlaps
from ...core.bbox.transforms import clip_boxes
from ...ops.point_sample import batched_point_sample
from ...ops.roi_align import _div
from ...utils.registry import DETECTORS, HEADS
from ..layers.norm import GroupNorm
from ..layers.precision import Conv2d, Linear
from ..layers.resize import resize_nearest
from ..losses import binary_cross_entropy, cross_entropy
from ..roi_heads.standard_roi_head import extract_roi_feats_fpn
from .faster_rcnn_fpn import ROI_STRIDES, FasterRCNNFPN
from .mask_rcnn import MaskRCNN, select_class_masks

ROI_CHANNELS = 256


def own_class(x: torch.Tensor, labels: torch.Tensor,
              num_classes: int) -> torch.Tensor:
    """x (B, S, ..., K) → (B, S, ...): each RoI's channel of its label,
    clipped to [0, K - 1] (a background row reads class K - 1)."""
    lbl = labels.long().clamp(0, num_classes - 1)
    idx = lbl.view(*lbl.shape, *(1,) * (x.dim() - lbl.dim()))
    return torch.gather(x, -1, idx.expand(*x.shape[:-1], 1))[..., 0]


def _nchw(roi_feats: torch.Tensor) -> torch.Tensor:
    """(..., s, s, C) NHWC RoI features → an (N, C, s, s) channels_last
    view, the RoIs folded into the batch."""
    s, c = roi_feats.shape[-2:]
    return roi_feats.reshape(-1, s, s, c).permute(0, 3, 1, 2)


# ---- Mask Scoring R-CNN ----------------------------------------------------

@HEADS.register_module()
class MaskIoUHead(nn.Module):
    """mmdet's `MaskIoUHead`: the (B, S, s, s, C) mask features and the
    (B, S, 2s, 2s, 1) own-class mask probabilities, downsampled to s by
    JAX's nearest rule, concatenated → 4 3x3 convs (the last at stride 2)
    with ReLU → fc0, fc1 (1024, ReLU) over the (y, x, C) flattened map →
    the per-class mask IoU (B, S, K) in f32."""

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 conv_out: int = 256, roi_size: int = 14, fc_out: int = 1024,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        conv = functools.partial(Conv2d, kernel_size=3, padding=1,
                                 compute_dtype=dtype)
        for i in range(4):
            self.add_module(f'conv{i}', conv(
                in_channels + 1 if i == 0 else conv_out, conv_out,
                stride=2 if i == 3 else 1))
        fc = functools.partial(Linear, compute_dtype=dtype)
        self.fc0 = fc(conv_out * (roi_size // 2) ** 2, fc_out)
        self.fc1 = fc(fc_out, fc_out)
        self.iou_out = fc(fc_out, num_classes)

    def forward(self, mask_feats: torch.Tensor,
                mask_probs: torch.Tensor) -> torch.Tensor:
        b, s, h, w, _ = mask_feats.shape
        mp = resize_nearest(mask_probs, (h, w), dims=(2, 3))
        x = _nchw(torch.cat([mask_feats, mp.to(mask_feats.dtype)], -1))
        for i in range(4):
            x = torch.relu(getattr(self, f'conv{i}')(x))
        x = x.permute(0, 2, 3, 1).reshape(b, s, -1)
        x = torch.relu(self.fc0(x))
        x = torch.relu(self.fc1(x))
        return self.iou_out(x).float()


@DETECTORS.register_module()
class MaskScoringRCNN(MaskRCNN):
    """Mask R-CNN plus the MaskIoU head; the test score is the class score
    x the clipped predicted IoU of the detection's mask."""

    def __init__(self, num_classes: int = 80, mask_size: int = 28, **kwargs):
        super().__init__(num_classes=num_classes, mask_size=mask_size,
                         **kwargs)
        self.mask_iou_head = MaskIoUHead(
            num_classes=num_classes,
            in_channels=kwargs.get('neck_channels', ROI_CHANNELS),
            roi_size=mask_size // 2, dtype=self.dtype)

    def loss(self, batch, generator=None, sampler_priorities=None):
        losses, m = self._mask_losses(batch, generator, sampler_priorities)
        labels = m.sampled.labels
        with record_function('step/mask_iou_head_and_loss'):
            probs = torch.sigmoid(own_class(m.logits, labels,
                                            self.num_classes))
            with torch.no_grad():
                pred = probs > 0.5
                gt = m.targets > 0.5
                inter = (pred & gt).sum((-2, -1))
                union = (pred | gt).sum((-2, -1))
                iou_t = inter / torch.clamp(union, min=1).float()
            iou_p = self.mask_iou_head(m.feats, probs[..., None])
            iou_sel = own_class(iou_p, labels, self.num_classes)
            losses['loss_mask_iou'] = 0.5 * torch.sum(
                (iou_sel - iou_t) ** 2 * m.pos_w) / torch.clamp(
                    m.pos_w.sum(), min=1.0)
        return losses

    @torch.inference_mode()
    def predict(self, batch):
        out, maps = self._detect(batch)
        det_boxes = out['dets'][..., :4].contiguous()
        mask_feats = self.roi_extract(maps, det_boxes,
                                      out_size=self.mask_size // 2,
                                      flatten=False)
        probs = select_class_masks(self.mask_head(mask_feats),
                                   out['labels'], self.num_classes)
        out['masks'] = probs
        iou_p = self.mask_iou_head(mask_feats, probs[..., None])
        iou_sel = own_class(iou_p, out['labels'], self.num_classes)
        scores = out['dets'][..., 4] * iou_sel.clamp(0.0, 1.0)
        out['dets'] = torch.cat([det_boxes, scores[..., None]], -1)
        return out


# ---- Double-Head R-CNN -----------------------------------------------------

@HEADS.register_module()
class DoubleBBoxHead(nn.Module):
    """mmdet's `DoubleConvFCBBoxHead`: the conv branch (a 1x1 `res_in`,
    `num_convs` residual bottlenecks 1x1 → 3x3 → 1x1 with ReLU after the
    sum, global average pooling) gives the per-class deltas; the fc branch
    (`num_fcs` FCs with ReLU over the (y, x, C) flattened RoI features)
    the K + 1 class logits. (B, S, s, s, C) → cls (f32), reg (f32), the fc
    branch's feature."""

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 roi_feat_size: int = 7, num_convs: int = 4, num_fcs: int = 2,
                 conv_out: int = 1024, fc_out: int = 1024,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_convs = num_convs
        self.num_fcs = num_fcs
        conv = functools.partial(Conv2d, compute_dtype=dtype)
        self.res_in = conv(in_channels, conv_out, 1)
        for i in range(num_convs):
            self.add_module(f'res{i}_1', conv(conv_out, conv_out // 4, 1))
            self.add_module(f'res{i}_2', conv(conv_out // 4, conv_out // 4, 3,
                                              padding=1))
            self.add_module(f'res{i}_3', conv(conv_out // 4, conv_out, 1))
        fc = functools.partial(Linear, compute_dtype=dtype)
        self.fc_reg = fc(conv_out, 4 * num_classes)
        for i in range(num_fcs):
            self.add_module(f'fc{i}', fc(
                in_channels * roi_feat_size ** 2 if i == 0 else fc_out,
                fc_out))
        self.fc_cls = fc(fc_out, num_classes + 1)

    def forward(self, roi_feats: torch.Tensor):
        b, s = roi_feats.shape[:2]
        x = self.res_in(_nchw(roi_feats))
        for i in range(self.num_convs):
            h = torch.relu(getattr(self, f'res{i}_1')(x))
            h = torch.relu(getattr(self, f'res{i}_2')(h))
            x = torch.relu(x + getattr(self, f'res{i}_3')(h))
        pooled = x.mean((2, 3), dtype=torch.float32).to(x.dtype)
        reg = self.fc_reg(pooled).float().reshape(b, s, -1)
        y = roi_feats.reshape(b, s, -1)
        for i in range(self.num_fcs):
            y = torch.relu(getattr(self, f'fc{i}')(y))
        return self.fc_cls(y).float(), reg, y


@DETECTORS.register_module()
class DoubleHeadRCNN(FasterRCNNFPN):
    """Double-Head R-CNN: the box losses of `DoubleBBoxHead`, each x2."""

    bbox_head_type = DoubleBBoxHead

    def roi_extract(self, feats_nhwc, rois, out_size=7, flatten=False):
        """The RoI features as (B, R, o, o, C): the head reads them both as
        a map and (y, x, C) flattened."""
        return super().roi_extract(feats_nhwc, rois, out_size, flatten)

    def _box_losses(self, maps, sampled):
        return {k: v * 2.0
                for k, v in super()._box_losses(maps, sampled).items()}


# ---- Dynamic R-CNN ---------------------------------------------------------

def _max_iou(boxes: torch.Tensor, gt: torch.Tensor,
             gt_valid: torch.Tensor) -> torch.Tensor:
    """(B, N) each box's best IoU with the valid gt boxes (0 without)."""
    ious = bbox_overlaps(gt, boxes)
    return torch.where(gt_valid[..., None], ious, ious.new_zeros(())).amax(1)


@DETECTORS.register_module()
class DynamicRCNN(FasterRCNNFPN):
    """Dynamic R-CNN with the batch's statistics (the JAX package's window
    of one step): see the module docstring."""

    def __init__(self, num_classes: int = 80, iou_topk: int = 75,
                 beta_topk: int = 10, **kwargs):
        super().__init__(num_classes=num_classes, **kwargs)
        self.iou_topk = iou_topk
        self.beta_topk = beta_topk

    def dynamic_iou_thr(self, proposals, batch) -> torch.Tensor:
        """The batch mean of each image's `iou_topk`-th best proposal IoU,
        clipped to [0.35, 0.75]."""
        best = _max_iou(proposals, batch['gt_bboxes'].to(proposals.dtype),
                        batch['gt_valid'])
        k = min(self.iou_topk, best.shape[1])
        top = torch.topk(best, k, dim=1).values[:, -1]
        return top.mean().clamp(0.35, 0.75)

    def dynamic_beta(self, err_sel: torch.Tensor,
                     is_pos: torch.Tensor) -> torch.Tensor:
        """The (`beta_topk` x B)-th smallest of the positives' mean errors
        (B, S, 4) → (), 1.0 where fewer RoIs are positive, clipped to
        [0.01, 1]; it carries the gradient of the element it picks (the
        lower index among ties, as JAX's top-k)."""
        mean_err = torch.where(is_pos[..., None], err_sel,
                               err_sel.new_full((), float('inf'))).mean(-1)
        b, s = mean_err.shape
        k = min(self.beta_topk, s) * b
        flat = mean_err.reshape(-1)
        order = torch.sort(flat, stable=True).indices
        beta = flat[order[k - 1]]
        beta = torch.where(torch.isfinite(beta), beta, beta.new_ones(()))
        return beta.clamp(0.01, 1.0)

    def loss(self, batch, generator=None, sampler_priorities=None):
        maps, losses, sampled, proposals = self._sample(
            batch, generator, sampler_priorities)
        with torch.no_grad(), record_function('step/dynamic_iou'):
            thr = self.dynamic_iou_thr(proposals, batch)
            ious = _max_iou(sampled.rois, batch['gt_bboxes'].to(
                sampled.rois.dtype), batch['gt_valid'])
            demote = sampled.is_pos & (ious < thr)
            sampled = sampled._replace(
                labels=torch.where(demote, self.num_classes, sampled.labels),
                is_pos=sampled.is_pos & ~demote)
        with record_function('step/roi_align_fwd'):
            roi_feats = self.roi_extract(maps, sampled.rois)
        with record_function('step/bbox_head_and_loss'):
            cls_s, reg_s, _ = self.bbox_head(roi_feats)
            b, s = sampled.labels.shape
            err = (reg_s.float() - sampled.reg_targets.repeat(
                1, 1, self.num_classes)).abs()
            err_sel = own_class(err.reshape(b, s, self.num_classes, 4)
                                .transpose(-1, -2), sampled.labels,
                                self.num_classes)
            beta = self.dynamic_beta(err_sel, sampled.is_pos)
            w = sampled.label_valid.float()
            loss_cls = cross_entropy(cls_s, sampled.labels, weight=w,
                                     reduction='sum') / torch.clamp(
                                         w.sum(), min=1.0)
            pos_w = sampled.is_pos.float()
            diff = err_sel.abs()
            sl1 = torch.where(diff < beta, 0.5 * diff * diff / beta,
                              diff - 0.5 * beta)
            loss_reg = torch.sum(sl1.sum(-1) * pos_w) / torch.clamp(
                pos_w.sum(), min=1.0)
            losses['loss_cls'] = loss_cls
            losses['loss_bbox'] = loss_reg
        return losses


# ---- Grid R-CNN ------------------------------------------------------------

@HEADS.register_module()
class GridHead(nn.Module):
    """mmdet's `GridHead` as the JAX package has it: 8 x (3x3 conv, 8-group
    GroupNorm over every RoI of an image, ReLU), a residual first-order
    `fusion` conv, nearest 2x, `up1` conv with ReLU, nearest 2x, the
    9-point `logits` conv: (B, S, s, s, C) → (B, S, 4s, 4s, 9) f32."""

    def __init__(self, in_channels: int = 256, grid_points: int = 9,
                 conv_out: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        conv = functools.partial(Conv2d, kernel_size=3, padding=1,
                                 compute_dtype=dtype)
        for i in range(8):
            self.add_module(f'conv{i}', conv(in_channels if i == 0
                                             else conv_out, conv_out))
            self.add_module(f'gn{i}', GroupNorm(conv_out, num_groups=8,
                                                channel_dim=2))
        self.fusion = conv(conv_out, conv_out)
        self.up1 = conv(conv_out, conv_out)
        self.logits = conv(conv_out, grid_points)

    def forward(self, roi_feats: torch.Tensor) -> torch.Tensor:
        b, s, h, w, _ = roi_feats.shape
        x = _nchw(roi_feats)
        for i in range(8):
            y = getattr(self, f'conv{i}')(x)
            y = getattr(self, f'gn{i}')(y.reshape(b, s, *y.shape[1:]))
            x = torch.relu(y.reshape(b * s, *y.shape[2:]))
        x = torch.relu(self.fusion(x)) + x
        up = resize_nearest(x, (2 * h, 2 * w))
        up = torch.relu(self.up1(up))
        up = resize_nearest(up, (4 * h, 4 * w))
        logits = self.logits(up).float()
        return logits.permute(0, 2, 3, 1).reshape(b, s, 4 * h, 4 * w, -1)


def expand2x(boxes: torch.Tensor) -> torch.Tensor:
    """The 2x-expanded RoI frame the grid targets and decodes live in."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return torch.stack([boxes[..., 0] - w / 2, boxes[..., 1] - h / 2,
                        boxes[..., 2] + w / 2, boxes[..., 3] + h / 2], -1)


@DETECTORS.register_module()
class GridRCNN(FasterRCNNFPN):
    """Grid R-CNN: classification from the Shared2FC head, localisation
    from the grid head's 9 point heatmaps (see the module docstring)."""

    def __init__(self, num_classes: int = 80, grid_size: int = 56,
                 **kwargs):
        super().__init__(num_classes=num_classes, **kwargs)
        self.grid_size = grid_size
        self.grid_head = GridHead(
            in_channels=kwargs.get('neck_channels', ROI_CHANNELS),
            dtype=self.dtype)

    def grid_targets(self, rois: torch.Tensor,
                     gt_boxes: torch.Tensor) -> torch.Tensor:
        """(B, S, G, G, 9) targets: the matched gt box's 9 grid points (x
        and y each at the left/top, centre, right/bottom; row-major) in the
        2x-expanded RoI frame at grid size G, a radius-1 circle each."""
        gs = self.grid_size
        rois = expand2x(rois)
        x1, y1 = rois[..., 0], rois[..., 1]
        w = torch.clamp(rois[..., 2] - rois[..., 0], min=1e-3)
        h = torch.clamp(rois[..., 3] - rois[..., 1], min=1e-3)
        gx = torch.stack([gt_boxes[..., 0],
                          (gt_boxes[..., 0] + gt_boxes[..., 2]) / 2,
                          gt_boxes[..., 2]], -1)
        gy = torch.stack([gt_boxes[..., 1],
                          (gt_boxes[..., 1] + gt_boxes[..., 3]) / 2,
                          gt_boxes[..., 3]], -1)
        px = gx.repeat(1, 1, 3)
        py = gy.repeat_interleave(3, dim=-1)
        u = (px - x1[..., None]) / w[..., None] * gs
        v = (py - y1[..., None]) / h[..., None] * gs
        ui = torch.floor(u).clamp(0, gs - 1)
        vi = torch.floor(v).clamp(0, gs - 1)
        grid = torch.arange(gs, device=rois.device, dtype=u.dtype)
        d2 = (grid[:, None] - vi[..., None, None]) ** 2 + \
            (grid[None, :] - ui[..., None, None]) ** 2
        return (d2 <= 1.0).float().permute(0, 1, 3, 4, 2)

    def loss(self, batch, generator=None, sampler_priorities=None):
        maps, losses, sampled, _ = self._sample(
            batch, generator, sampler_priorities)
        with record_function('step/roi_align_fwd'):
            roi_feats = self.roi_extract(maps, sampled.rois)
        with record_function('step/bbox_head_and_loss'):
            cls_s, _, _ = self.bbox_head(roi_feats)
            w = sampled.label_valid.float()
            losses['loss_cls'] = cross_entropy(
                cls_s, sampled.labels, weight=w, reduction='sum') / \
                torch.clamp(w.sum(), min=1.0)
        with record_function('step/grid_roi_align_fwd'):
            grid_feats = self.roi_extract(maps, sampled.rois, out_size=14,
                                          flatten=False)
        with record_function('step/grid_head_and_loss'):
            logits = self.grid_head(grid_feats)
            idx = sampled.matched_gt.long()
            gt_m = torch.gather(batch['gt_bboxes'].float(), 1,
                                idx[..., None].expand(*idx.shape, 4))
            targets = self.grid_targets(sampled.rois, gt_m)
            pos_w = (sampled.is_pos & sampled.label_valid).float()
            bce = binary_cross_entropy(logits, targets, reduction='none')
            losses['loss_grid'] = 15.0 * torch.sum(
                bce.mean((-3, -2, -1)) * pos_w) / torch.clamp(pos_w.sum(),
                                                              min=1.0)
        return losses

    def level_extract(self, feats_nhwc, rois, out_size=7, flatten=True):
        """The level-assigned extractor, which serving uses whatever
        `roi_extractor_type` says (as the JAX package's predict does)."""
        return extract_roi_feats_fpn(feats_nhwc, rois, ROI_STRIDES,
                                     out_size=out_size, flatten=flatten)

    @staticmethod
    def grid_cells(logits: torch.Tensor) -> torch.Tensor:
        """(B, S, G, G, P) heatmaps → (B, S, P) the flat index of each
        point's argmax cell."""
        b, s, gs = logits.shape[:3]
        return logits.reshape(b, s, gs * gs, -1).argmax(2)

    @torch.inference_mode()
    def predict(self, batch):
        out, maps = self._detect(batch, with_reg=False,
                                 roi_extractor=self.level_extract)
        det = out['dets'][..., :4].contiguous()
        logits = self.grid_head(self.level_extract(maps, det, out_size=14,
                                                   flatten=False))
        gs = logits.shape[2]
        idx = self.grid_cells(logits)
        vi = torch.div(idx, gs, rounding_mode='floor').float() + 0.5
        ui = (idx % gs).float() + 0.5
        exp = expand2x(det)
        x1, y1 = exp[..., 0], exp[..., 1]
        w = torch.clamp(exp[..., 2] - exp[..., 0], min=1e-3)
        h = torch.clamp(exp[..., 3] - exp[..., 1], min=1e-3)
        px = x1[..., None] + _div(ui, gs) * w[..., None]
        py = y1[..., None] + _div(vi, gs) * h[..., None]
        new_boxes = torch.stack([px[..., 0::3].mean(-1),
                                 py[..., 0:3].mean(-1),
                                 px[..., 2::3].mean(-1),
                                 py[..., 6:9].mean(-1)], -1)
        new_boxes = clip_boxes(new_boxes,
                               batch['img_shape'][:, None, :].float())
        out['dets'] = torch.cat([new_boxes, out['dets'][..., 4:]], -1)
        return out


# ---- PointRend -------------------------------------------------------------

@HEADS.register_module()
class PointHead(nn.Module):
    """PointRend's point head (mmdet's `MaskPointHead`): `num_fcs` FCs
    with ReLU over [fine-grained point features, coarse point logits],
    the coarse logits joined again after each; the per-class point logits
    (f32)."""

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 num_fcs: int = 3, dim: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_fcs = num_fcs
        fc = functools.partial(Linear, compute_dtype=dtype)
        for i in range(num_fcs):
            self.add_module(f'fc{i}', fc(
                (in_channels if i == 0 else dim) + num_classes, dim))
        self.logits = fc(dim + num_classes, num_classes)

    def forward(self, fine: torch.Tensor, coarse: torch.Tensor
                ) -> torch.Tensor:
        x = torch.cat([fine, coarse], -1)
        for i in range(self.num_fcs):
            x = torch.relu(getattr(self, f'fc{i}')(x))
            x = torch.cat([x, coarse.to(x.dtype)], -1)
        return self.logits(x).float()


@DETECTORS.register_module()
class PointRend(MaskRCNN):
    """PointRend on Mask R-CNN: the point loss at the most uncertain points
    of each coarse mask; serving refines the coarse mask there once (the
    reference subdivides further)."""

    def __init__(self, num_classes: int = 80, mask_size: int = 28,
                 num_points: int = 196, **kwargs):
        super().__init__(num_classes=num_classes, mask_size=mask_size,
                         **kwargs)
        self.num_points = num_points
        self.point_head = PointHead(
            num_classes=num_classes,
            in_channels=kwargs.get('neck_channels', ROI_CHANNELS),
            dtype=self.dtype)

    def point_coords(self, mask_logits: torch.Tensor, labels: torch.Tensor):
        """The `num_points` most uncertain points (smallest |logit| of the
        own class; the lower index first among ties, as JAX's top-k) →
        (normalized (x, y) in the RoI frame (B, S, K, 2), flat indices
        (B, S, K))."""
        b, s, h, w, _ = mask_logits.shape
        unc = -own_class(mask_logits, labels, self.num_classes).abs()
        k = min(self.num_points, h * w)
        idx = torch.sort(unc.reshape(b, s, h * w), dim=-1, descending=True,
                         stable=True).indices[..., :k]
        ys = torch.div(idx, w, rounding_mode='floor').float()
        xs = (idx % w).float()
        pts = torch.stack([_div(xs + 0.5, w), _div(ys + 0.5, h)], -1)
        return pts, idx

    @staticmethod
    def point_feats(maps, rois: torch.Tensor, pts: torch.Tensor):
        """P2's features (B, S, K, C) at the RoI-relative points."""
        b, s, k, _ = pts.shape
        x = rois[..., 0:1] + pts[..., 0] * (rois[..., 2:3] - rois[..., 0:1])
        y = rois[..., 1:2] + pts[..., 1] * (rois[..., 3:4] - rois[..., 1:2])
        fh, fw = maps[0].shape[1:3]
        norm = torch.stack([_div(x * 0.25, fw), _div(y * 0.25, fh)], -1)
        return batched_point_sample(maps[0], norm.reshape(b, s * k, 2)
                                    ).reshape(b, s, k, -1)

    @staticmethod
    def sample_rois_maps(maps: torch.Tensor, pts: torch.Tensor):
        """Each RoI's (B, S, h, w, C) map sampled at its own (B, S, K, 2)
        points → (B, S, K, C)."""
        b, s, h, w, c = maps.shape
        k = pts.shape[2]
        return batched_point_sample(maps.reshape(b * s, h, w, c),
                                    pts.reshape(b * s, k, 2)
                                    ).reshape(b, s, k, c)

    def loss(self, batch, generator=None, sampler_priorities=None):
        losses, m = self._mask_losses(batch, generator, sampler_priorities)
        sampled, mask_logits = m.sampled, m.logits
        with record_function('step/point_head_and_loss'):
            pts, _ = self.point_coords(mask_logits.detach(), sampled.labels)
            fine = self.point_feats(m.maps, sampled.rois, pts)
            coarse = self.sample_rois_maps(mask_logits, pts)
            pt_logits = self.point_head(fine, coarse)
            t = self.sample_rois_maps(m.targets[..., None], pts)[..., 0]
            pl = own_class(pt_logits, sampled.labels, self.num_classes)
            bce = binary_cross_entropy(pl, t, reduction='none')
            losses['loss_point'] = torch.sum(bce.mean(-1) * m.pos_w) / \
                torch.clamp(m.pos_w.sum(), min=1.0)
        return losses

    @torch.inference_mode()
    def predict(self, batch):
        out, maps = self._detect(batch)
        det_boxes = out['dets'][..., :4].contiguous()
        mask_logits = self.mask_head(self.roi_extract(
            maps, det_boxes, out_size=self.mask_size // 2, flatten=False))
        pts, idx = self.point_coords(mask_logits, out['labels'])
        fine = self.point_feats(maps, det_boxes, pts)
        coarse = self.sample_rois_maps(mask_logits, pts)
        pt_logits = self.point_head(fine, coarse)
        sel = own_class(mask_logits, out['labels'], self.num_classes)
        b, s, h, w = sel.shape
        repl = own_class(pt_logits, out['labels'], self.num_classes)
        # the refined logits in the coarse ones' dtype, as JAX sets them
        flat = sel.reshape(b, s, h * w).scatter(-1, idx, repl.to(sel.dtype))
        out['masks'] = torch.sigmoid(flat.reshape(b, s, h, w)).float()
        return out
