"""Hybrid Task Cascade R50-FPN (counterpart of the JAX package's
`models/detectors/htc.py`).

The three-stage box cascade of `cascade_rcnn.py`, interleaved with a mask
head per stage (`HTCMaskHead`), where each stage's mask head also reads the
previous stage's mask feature through a 1x1 `info_flow` adapter, and with
an optional semantic branch (`FusedSemanticHead`, `with_semantic`): all
five pyramid levels fused at stride 8, whose feature map is pooled for
every RoI and added to its box (7x7) and mask (14x14) features.

The semantic pool passes the one stride-8 map as all four pyramid levels
(`(sem,) * 4` at the strides 4–32), as the JAX package does: each RoI
samples the map at its level's scale, so a level-0 RoI samples it at twice
its true scale, and samples past the map contribute zero. The kernel pair
takes the same tensor as four levels, and the backward's four level
gradients sum into it.

The semantic loss, 0.2 x the cross-entropy of the semantic logits against
`gt_semantic_seg` (resized nearest to the stride-8 map, labels at or above
`semantic_classes` ignored), is computed only when the batch carries
`gt_semantic_seg`; the COCO pipelines carry none, and the semantic logits
then get no gradient (weight decay still moves them, as in JAX).
Prediction averages the three stages' sigmoid masks on the detections
(each stage's head fed the previous one's feature); the last stage decodes
the detections from the pyramid's features alone (no semantic term), as
the JAX package does.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from ...utils.registry import DETECTORS
from ..layers.precision import Conv2d
from ..layers.resize import resize_nearest
from .cascade_rcnn import NUM_STAGES, ROI_CHANNELS, CascadeMaskRCNN
from .mask_rcnn import select_class_masks


class HTCMaskHead(nn.Module):
    """The FCN mask head with HTC's information flow: the input plus a 1x1
    `info_flow` conv of the previous stage's feature (when `info_flow`),
    `num_convs` x (3x3 conv, ReLU), a nearest 2x upsample, a 3x3
    `upsample_conv` with ReLU and the per-class 1x1 `logits`, each at
    `dtype`."""

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 conv_out: int = 256, num_convs: int = 4,
                 info_flow: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_convs = num_convs
        conv = functools.partial(Conv2d, compute_dtype=dtype)
        if info_flow:
            self.info_flow = conv(conv_out, in_channels, 1)
        for i in range(num_convs):
            self.add_module(f'conv{i}', conv(
                in_channels if i == 0 else conv_out, conv_out, 3, padding=1))
        self.upsample_conv = conv(conv_out, conv_out, 3, padding=1)
        self.logits = conv(conv_out, num_classes, 1)

    def forward(self, roi_feats: torch.Tensor,
                last_feat: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(..., R, s, s, C) NHWC RoI features → (..., R, 2s, 2s, K) f32
        logits, and the feature after the convs as an (N, C, s, s) map
        (N = the RoIs of every image), which is the next stage's
        `last_feat`."""
        lead, (s, c) = roi_feats.shape[:-3], roi_feats.shape[-2:]
        x = roi_feats.reshape(-1, s, s, c).permute(0, 3, 1, 2)
        if last_feat is not None:
            x = x + self.info_flow(last_feat)
        for i in range(self.num_convs):
            x = torch.relu(getattr(self, f'conv{i}')(x))
        feat = x
        x = F.interpolate(x, scale_factor=2, mode='nearest')
        x = self.logits(torch.relu(self.upsample_conv(x))).float()
        return x.permute(0, 2, 3, 1).reshape(*lead, 2 * s, 2 * s, -1), feat


class FusedSemanticHead(nn.Module):
    """The semantic branch: a 1x1 `lateral<i>` conv of each pyramid level,
    each resized (half-pixel nearest) to level 1's size and summed, four
    3x3 convs with ReLU, and the per-pixel class `logits`."""

    def __init__(self, num_classes: int = 183, in_channels: int = 256,
                 conv_out: int = 256, num_levels: int = 5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        conv = functools.partial(Conv2d, compute_dtype=dtype)
        self.num_levels = num_levels
        for i in range(num_levels):
            self.add_module(f'lateral{i}', conv(in_channels, conv_out, 1))
        for i in range(4):
            self.add_module(f'conv{i}', conv(
                conv_out, conv_out, 3, padding=1))
        self.logits = conv(conv_out, num_classes, 1)

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The pyramid's (B, C, H_l, W_l) levels → (B, K, H_1, W_1) f32
        logits and the (B, C, H_1, W_1) feature."""
        size = tuple(feats[1].shape[-2:])
        acc = None
        for i, f in enumerate(feats[:self.num_levels]):
            h = getattr(self, f'lateral{i}')(f)
            # gathered in the NHWC view, so a channels_last map stays one
            h = resize_nearest(h.permute(0, 2, 3, 1), size,
                               dims=(1, 2)).permute(0, 3, 1, 2)
            acc = h if acc is None else acc + h
        x = acc
        for i in range(4):
            x = torch.relu(getattr(self, f'conv{i}')(x))
        return self.logits(x).float(), x


def semantic_loss(logits: torch.Tensor, gt_semantic_seg: torch.Tensor,
                  num_classes: int) -> torch.Tensor:
    """0.2 x the mean cross-entropy of (B, K, h, w) logits over the pixels
    of `gt_semantic_seg` (B, H, W) resized nearest to (h, w) whose label is
    below K (the rest, 255 among them, are ignored)."""
    tgt = resize_nearest(gt_semantic_seg.long(), tuple(logits.shape[-2:]))
    valid = (tgt < num_classes).float()
    logp = torch.log_softmax(logits, dim=1)
    ce = -torch.gather(logp, 1, tgt.clamp(0, num_classes - 1)[:, None])[:, 0]
    return 0.2 * (ce * valid).sum() / torch.clamp(valid.sum(), min=1.0)


@DETECTORS.register_module()
class HTC(CascadeMaskRCNN):
    """Cascade R-CNN with interleaved, information-flowing mask heads
    (`mask_head_0` … `mask_head_2`) and the optional semantic branch
    (`semantic_head`, `semantic_classes` classes)."""

    def __init__(self, num_classes: int = 80, mask_size: int = 28,
                 with_semantic: bool = True, semantic_classes: int = 183,
                 **kwargs):
        super().__init__(num_classes=num_classes, mask_size=mask_size,
                         **kwargs)
        self.with_semantic = with_semantic
        self.semantic_classes = semantic_classes
        if with_semantic:
            self.semantic_head = FusedSemanticHead(
                num_classes=semantic_classes, in_channels=ROI_CHANNELS,
                dtype=self.dtype)

    def _make_mask_heads(self, num_classes: int) -> None:
        """One `HTCMaskHead` a stage; all but the first take the previous
        stage's feature."""
        for i in range(NUM_STAGES):
            self.add_module(f'mask_head_{i}', HTCMaskHead(
                num_classes=num_classes, in_channels=ROI_CHANNELS,
                info_flow=i > 0, dtype=self.dtype))

    def roi_context(self, feats, batch=None, losses=None):
        """The semantic branch's stride-8 feature as a (B, h, w, C) map for
        the RoI pool (with `with_semantic`); with a batch that carries
        `gt_semantic_seg`, `loss_semantic` joins `losses`."""
        if not self.with_semantic:
            return {}
        with record_function('step/semantic_head'):
            logits, sem = self.semantic_head(feats)
            if batch is not None and 'gt_semantic_seg' in batch:
                losses['loss_semantic'] = semantic_loss(
                    logits, batch['gt_semantic_seg'], self.semantic_classes)
        return dict(semantic=sem.permute(0, 2, 3, 1).contiguous())

    def _semantic_pool(self, ctx, rois: torch.Tensor, out_size: int = 7,
                       flatten: bool = True) -> torch.Tensor:
        """RoIAlign of the semantic map, given as all four levels."""
        return self.roi_extract((ctx['semantic'],) * 4, rois,
                                out_size=out_size, flatten=flatten)

    def _box_feats(self, maps, ctx, rois):
        feats = self.roi_extract(maps, rois)
        if 'semantic' in ctx:
            feats = feats + self._semantic_pool(ctx, rois)
        return feats

    def _final_box_feats(self, maps, ctx, rois):
        return self.roi_extract(maps, rois)

    def _mask_feats(self, maps, ctx, rois: torch.Tensor) -> torch.Tensor:
        """The (B, R, 14, 14, C) mask features, with the semantic pool."""
        m = self.mask_size // 2
        feats = self.roi_extract(maps, rois, out_size=m, flatten=False)
        if 'semantic' in ctx:
            feats = feats + self._semantic_pool(ctx, rois, m, flatten=False)
        return feats

    def _stage_extras(self, i, maps, ctx, sampled, gt_masks, batch, carry):
        """Stage i's mask loss; the mask feature flows to stage i + 1."""
        with record_function('step/mask_roi_align_fwd'):
            feats = self._mask_feats(maps, ctx, sampled.rois)
        with record_function('step/mask_head_and_loss'):
            logits, feat = self.mask_heads[i](feats, carry)
        return self._mask_terms(logits, sampled, gt_masks, batch), feat

    def mask_predict(self, maps, out: Dict[str, torch.Tensor], ctx=None
                     ) -> torch.Tensor:
        """The mean of the three stages' sigmoid maps at each detection's
        class, each stage's head fed the previous one's feature."""
        feats = self._mask_feats(maps, ctx or {},
                                 out['dets'][..., :4].contiguous())
        probs, last = None, None
        for head in self.mask_heads:
            logits, last = head(feats, last)
            p = select_class_masks(logits, out['labels'], self.num_classes)
            probs = p if probs is None else probs + p
        return probs / 3.0
