"""SCNet R50-FPN (counterpart of the JAX package's
`models/detectors/scnet.py`): HTC's cascade and semantic branch with three
changes.

1. A global-context head (`glbctx_head`) classifies which classes the
   image holds (multilabel, `loss_glbctx` = 3 x the mean BCE against the
   valid gt labels) from the coarsest level, and its 1024-d feature is
   added to every box RoI feature's first C channels.
2. The mask head runs once (`scnet_mask_head`, no per-stage mask heads
   and no information flow), on the last stage's sampled RoIs, unweighted
   (`loss_mask`).
3. A feature-relay head (`relay_head`) turns the last box head's shared
   1024-d feature into a 14x14 map (a Dense layer viewed as (7, 7, C) in
   (y, x, C) order, then a bilinear 2x resize) added to the mask features.

As in the JAX package, no per-stage mask heads exist (flax creates none,
since SCNet never calls HTC's), so the parameter trees match. At test
time the mask branch runs on the detections with the relay of the last
box head's feature on them; the detections decode from the box features
with the semantic and global-context terms.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from ...utils.registry import DETECTORS
from ..layers.precision import Conv2d, Linear
from ..losses import binary_cross_entropy
from ..roi_heads.mask_head import upsample_bilinear_2x
from .cascade_rcnn import ROI_CHANNELS
from .htc import HTC, HTCMaskHead
from .mask_rcnn import select_class_masks


class GlobalContextHead(nn.Module):
    """Four 3x3 convs with ReLU on the coarsest level, the spatial mean, a
    1024-d `fc` with ReLU and the per-class `fc_cls` logits."""

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 conv_out: int = 256, fc_out: int = 1024,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        conv = functools.partial(Conv2d, compute_dtype=dtype)
        for i in range(4):
            self.add_module(f'conv{i}', conv(
                in_channels if i == 0 else conv_out, conv_out, 3, padding=1))
        self.fc = Linear(conv_out, fc_out, compute_dtype=dtype)
        self.fc_cls = Linear(fc_out, num_classes, compute_dtype=dtype)

    def forward(self, feats) -> Tuple[torch.Tensor, torch.Tensor]:
        """The pyramid's levels → (B, K) f32 logits and the (B, 1024)
        context feature."""
        x = feats[-1]
        for i in range(4):
            x = torch.relu(getattr(self, f'conv{i}')(x))
        feat = torch.relu(self.fc(x.mean(dim=(2, 3))))
        return self.fc_cls(feat).float(), feat


class FeatRelayHead(nn.Module):
    """The last box head's shared (B, S, 1024) feature → a (B, S, roi,
    roi, C) NHWC prior for the mask features: `fc` with ReLU to (roi/2)² x
    C values read as (y, x, C), resized bilinear (half-pixel) to roi x
    roi."""

    def __init__(self, in_channels: int = 1024, roi_size: int = 14,
                 out_channels: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.roi_size = roi_size
        self.out_channels = out_channels
        self.fc = Linear(in_channels,
                         roi_size * roi_size // 4 * out_channels,
                         compute_dtype=dtype)

    def forward(self, shared: torch.Tensor) -> torch.Tensor:
        b, s, _ = shared.shape
        h, c = self.roi_size // 2, self.out_channels
        x = torch.relu(self.fc(shared)).reshape(b * s, h, h, c)
        x = upsample_bilinear_2x(x.permute(0, 3, 1, 2))
        return x.permute(0, 2, 3, 1).reshape(b, s, 2 * h, 2 * h, c)


@DETECTORS.register_module()
class SCNet(HTC):
    """HTC's cascade and semantic branch with the global-context head, one
    mask head with the feature relay (see the module docstring)."""

    def _make_mask_heads(self, num_classes: int) -> None:
        """The global-context, relay and single mask heads (no per-stage
        mask heads)."""
        self.glbctx_head = GlobalContextHead(
            num_classes=num_classes, in_channels=ROI_CHANNELS,
            dtype=self.dtype)
        self.relay_head = FeatRelayHead(roi_size=self.mask_size // 2,
                                        out_channels=ROI_CHANNELS,
                                        dtype=self.dtype)
        self.scnet_mask_head = HTCMaskHead(
            num_classes=num_classes, in_channels=ROI_CHANNELS,
            dtype=self.dtype)

    def roi_context(self, feats, batch=None, losses=None):
        """HTC's semantic map (without its loss), and the global context
        feature; in training `loss_glbctx` joins `losses`."""
        ctx = super().roi_context(feats)
        with record_function('step/global_context'):
            logits, ctx['global'] = self.glbctx_head(feats)
            if batch is not None:
                k = self.num_classes
                onehot = torch.nn.functional.one_hot(
                    batch['gt_labels'].long().clamp(0, k - 1), k)
                present = (onehot * batch['gt_valid'][..., None]).any(
                    dim=1).float()
                losses['loss_glbctx'] = 3.0 * binary_cross_entropy(
                    logits, present, reduction='mean')
        return ctx

    def _box_feats(self, maps, ctx, rois):
        """HTC's box features plus the global context on each RoI's first C
        channels."""
        feats = super()._box_feats(maps, ctx, rois)
        c = maps[0].shape[-1]
        glb = ctx['global'][:, None, None, :c]
        return (feats.unflatten(-1, (-1, c)) + glb).flatten(-2)

    def _final_box_feats(self, maps, ctx, rois):
        return self._box_feats(maps, ctx, rois)

    def _stage_extras(self, i, maps, ctx, sampled, gt_masks, batch, carry):
        return {}, carry

    def _after_stages(self, maps, ctx, sampled, shared, gt_masks, batch,
                      losses):
        """The mask loss on the last stage's samples, with the relay of its
        shared box feature."""
        with record_function('step/mask_roi_align_fwd'):
            feats = self._mask_feats(maps, ctx, sampled.rois)
        with record_function('step/mask_head_and_loss'):
            feats = feats + self.relay_head(shared).to(feats.dtype)
            logits, _ = self.scnet_mask_head(feats)
        losses.update(self._mask_terms(logits, sampled, gt_masks, batch))

    def mask_predict(self, maps, out: Dict[str, torch.Tensor], ctx=None
                     ) -> torch.Tensor:
        """The mask head's sigmoid at each detection's class, with the
        relay of the last box head's feature on the detections."""
        dets = out['dets'][..., :4].contiguous()
        feats = self._mask_feats(maps, ctx, dets)
        _, _, shared = self.bbox_heads[-1](self._box_feats(maps, ctx, dets))
        feats = feats + self.relay_head(shared).to(feats.dtype)
        logits, _ = self.scnet_mask_head(feats)
        return select_class_masks(logits, out['labels'], self.num_classes)
