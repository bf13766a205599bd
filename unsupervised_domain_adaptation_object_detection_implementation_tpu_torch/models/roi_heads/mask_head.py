"""FCN mask head, box-frame mask targets and the mask loss (counterpart of
the JAX package's `models/roi_heads/mask_head.py`).

Each gt instance comes as a fixed M x M raster in its own box frame
(`PackDetInputs(with_mask=True)`). The target of a sampled RoI is a
bilinear crop of its matched gt's raster under the affine map from the RoI
to the gt box: one RoIAlign over (B·S, M, M, 1) single-RoI "images", at
scale 1 with the legacy `aligned=False` geometry. On a card that is one
forward launch of the RoIAlign kernel, without a gradient.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.roi_align import batched_roi_align
from ...parallel.batch import batch_total
from ...utils.registry import HEADS
from ..layers.precision import Conv2d
from ..losses import binary_cross_entropy


@HEADS.register_module()
class FCNMaskHead(nn.Module):
    """`num_convs` x (3x3 conv, ReLU) → 2x bilinear resize → 3x3
    `upsample_conv`, ReLU → per-class 1x1 `conv_logits`.

    `normed_predictor` (mmdet's `NormedConv2d` predictor) replaces the 1x1
    conv by `conv_logits_kernel` (C, K), L2-normed over its input channels,
    applied to the features L2-normed over channels and scaled by
    `normed_tempearture` (mmdet's spelling), as in the JAX head.

    Every conv computes at `dtype`; the normed predictor takes the
    features' norm in f32 and applies it, and the normed kernel, in
    `dtype`, as the JAX head does."""

    def __init__(self, num_classes: int = 80, num_convs: int = 4,
                 in_channels: int = 256, feat_channels: int = 256,
                 normed_predictor: bool = False,
                 normed_tempearture: float = 20.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.num_convs = num_convs
        self.normed_predictor = normed_predictor
        self.normed_tempearture = normed_tempearture
        for i in range(num_convs):
            self.add_module(f'conv{i}', Conv2d(
                in_channels if i == 0 else feat_channels, feat_channels, 3,
                padding=1, compute_dtype=dtype))
        self.upsample_conv = Conv2d(
            feat_channels if num_convs else in_channels, feat_channels, 3,
            padding=1, compute_dtype=dtype)
        if normed_predictor:
            self.conv_logits_kernel = nn.Parameter(
                torch.empty(feat_channels, num_classes))
        else:
            self.conv_logits = Conv2d(feat_channels, num_classes, 1,
                                      compute_dtype=dtype)

    def forward(self, roi_feats: torch.Tensor) -> torch.Tensor:
        """(..., R, s, s, C) NHWC RoI features → (..., R, 2s, 2s, K) logits.
        The RoIs fold into the batch as a channels_last (N, C, s, s) view
        (no copy), and the logits come back as a view of the channels_last
        result."""
        lead, (s, c) = roi_feats.shape[:-3], roi_feats.shape[-2:]
        x = roi_feats.reshape(-1, s, s, c).permute(0, 3, 1, 2)
        for i in range(self.num_convs):
            x = torch.relu(getattr(self, f'conv{i}')(x))
        x = upsample_bilinear_2x(x)
        x = torch.relu(self.upsample_conv(x))
        if self.normed_predictor:
            w = self.conv_logits_kernel
            w = w / (torch.linalg.vector_norm(w, dim=0, keepdim=True) + 1e-6)
            xn = x / (torch.linalg.vector_norm(x.float(), dim=1, keepdim=True)
                      + 1e-6).to(x.dtype)
            x = self.normed_tempearture * F.conv2d(
                xn, w.t()[:, :, None, None].to(x.dtype))
        else:
            x = self.conv_logits(x)
        return x.permute(0, 2, 3, 1).reshape(*lead, 2 * s, 2 * s, -1)


def upsample_bilinear_2x(x: torch.Tensor) -> torch.Tensor:
    """`jax.image.resize(..., 'bilinear')` at 2x of an NCHW map: half-pixel
    centres, the edge taps renormalised, which equals clamping the source
    coordinate. In f32 one pass; in bf16 the rows first, then the columns,
    each rounded to bf16, as the JAX resize contracts its two weight
    matrices one after the other."""
    h, w = x.shape[-2:]
    if x.dtype == torch.float32:
        return F.interpolate(x, scale_factor=2, mode='bilinear',
                             align_corners=False)
    x = F.interpolate(x, size=(2 * h, w), mode='bilinear',
                      align_corners=False)
    return F.interpolate(x, size=(2 * h, 2 * w), mode='bilinear',
                         align_corners=False)


def box_frame_crops(gt_masks: torch.Tensor, gt_boxes: torch.Tensor,
                    rois: torch.Tensor, matched_gt: torch.Tensor):
    """The mask-target RoIAlign's inputs: each sampled RoI's matched raster
    as a (B·S, M, M, 1) f32 map, and the RoI mapped into that gt's box frame
    scaled to M, as (B·S, 1, 4)."""
    b, _, m, _ = gt_masks.shape
    s = rois.shape[1]
    idx = matched_gt.long()
    boxes = torch.gather(gt_boxes.float(), 1,
                         idx[..., None].expand(b, s, 4))
    x1, y1 = boxes[..., 0], boxes[..., 1]
    bw = torch.clamp(boxes[..., 2] - x1, min=1e-3)
    bh = torch.clamp(boxes[..., 3] - y1, min=1e-3)
    frame_rois = torch.stack([(rois[..., 0] - x1) / bw * m,
                              (rois[..., 1] - y1) / bh * m,
                              (rois[..., 2] - x1) / bw * m,
                              (rois[..., 3] - y1) / bh * m], dim=-1)
    rasters = torch.gather(gt_masks, 1,
                           idx[..., None, None].expand(b, s, m, m))
    return (rasters.reshape(b * s, m, m, 1).float(),
            frame_rois.reshape(b * s, 1, 4).detach().contiguous())


def batch_gt_masks(batch) -> torch.Tensor:
    """The batch's (B, G, M, M) `gt_masks`. A batch without them, from a
    train pipeline whose `PackDetInputs` lacks `with_mask=True`, raises a
    KeyError, as the JAX step does."""
    if 'gt_masks' not in batch:
        raise KeyError(
            "gt_masks: the batch has no mask rasters; a Mask R-CNN train "
            "pipeline needs PackDetInputs(with_mask=True) (and "
            "LoadAnnotations(with_mask=True))")
    return batch['gt_masks']


def mask_targets_from_box_frame(gt_masks: torch.Tensor,
                                gt_boxes: torch.Tensor,
                                rois: torch.Tensor,
                                matched_gt: torch.Tensor,
                                out_size: int = 28) -> torch.Tensor:
    """Crop sampled-RoI mask targets out of box-frame gt rasters.

    Args:
        gt_masks: (B, G, M, M) rasters of each gt in its own box frame.
        gt_boxes: (B, G, 4).
        rois: (B, S, 4) sampled RoIs (image coordinates).
        matched_gt: (B, S) index of each RoI's matched gt.

    Returns:
        (B, S, out, out) float32 targets in [0, 1]; no gradient.
    """
    b, s = rois.shape[:2]
    rasters, frame_rois = box_frame_crops(gt_masks, gt_boxes, rois,
                                          matched_gt)
    crops = batched_roi_align(rasters, frame_rois, 1.0, out_size,
                              sampling_ratio=2, aligned=False)
    return crops.reshape(b, s, out_size, out_size)


def mask_loss(mask_logits: torch.Tensor,
              targets: torch.Tensor,
              labels: torch.Tensor,
              pos_weight: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-pixel BCE on each RoI's own-class channel, weighted by
    `pos_weight` (B, S) and summed over max(Σ pos_weight · h · w, 1), the
    sum over the global batch under data parallelism.
    Labels clip to [0, K - 1], so a background row reads class K - 1 at
    weight 0."""
    b, s, h, w, c = mask_logits.shape
    lbl = labels.long().clamp(0, c - 1)
    sel = torch.gather(mask_logits, -1,
                       lbl[..., None, None, None].expand(b, s, h, w, 1))[..., 0]
    loss = binary_cross_entropy(sel, targets,
                                weight=pos_weight[..., None, None],
                                reduction='sum')
    denom = torch.clamp(batch_total(pos_weight.sum()) * h * w, min=1.0)
    return dict(loss_mask=loss / denom)
