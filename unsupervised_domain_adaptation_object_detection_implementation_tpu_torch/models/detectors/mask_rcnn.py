"""Mask R-CNN R50-FPN (counterpart of the JAX package's
`models/detectors/mask_rcnn.py`): Faster R-CNN FPN plus an FCN mask head.

Training runs the mask branch on all the sampled RoIs, with the positives
weighted (the JAX package's static-shape form of mmdet's positives-only
mask forward: the same loss and gradients, no host sync): 14x14 RoIAlign
over P2–P5, the mask head, and targets cropped from the box-frame gt
rasters (`roi_heads/mask_head.py`). Prediction adds the sigmoid of each
detection's own-class 28x28 mask, padded rows included; `paste_masks`
puts them into the image.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ...utils.registry import DETECTORS
from ..roi_heads.mask_head import (FCNMaskHead, batch_gt_masks, mask_loss,
                                   mask_targets_from_box_frame)
from .faster_rcnn_fpn import FasterRCNNFPN

_PIL_BITS = 22                   # PIL's PRECISION_BITS for 8-bit resampling


def select_class_masks(mask_logits: torch.Tensor, labels: torch.Tensor,
                       num_classes: int) -> torch.Tensor:
    """(B, D, m, m, K) logits and (B, D) labels → (B, D, m, m) f32
    probabilities of each detection's class (labels clipped to [0, K-1])."""
    b, d, h, w, _ = mask_logits.shape
    lbl = labels.long().clamp(0, num_classes - 1)
    sel = torch.gather(mask_logits, -1,
                       lbl[..., None, None, None].expand(b, d, h, w, 1))
    return torch.sigmoid(sel[..., 0].float())


class MaskBranch(NamedTuple):
    """A train step's mask branch: the RoI extractor's NHWC levels, the
    sampled RoIs, their (B, S, s, s, C) mask features, (B, S, m, m, K)
    logits and (B, S, m, m) targets, and the positives' (B, S) weights."""
    maps: Tuple[torch.Tensor, ...]
    sampled: Any
    feats: torch.Tensor
    logits: torch.Tensor
    targets: torch.Tensor
    pos_w: torch.Tensor


@DETECTORS.register_module()
class MaskRCNN(FasterRCNNFPN):
    """`FasterRCNNFPN` with the FCN mask head (`mask_size` // 2 RoI
    features, 4 convs, 2x upsample). Only the softmax box classifier and
    the plain mask predictor or its normed form are ported; seesaw raises,
    as do the parts `FasterRCNNFPN` refuses."""

    with_mask = True

    def __init__(self, num_classes: int = 80, loss_cls: str = 'softmax',
                 normed_mask: bool = False, mask_size: int = 28, **kwargs):
        if loss_cls != 'softmax':
            raise NotImplementedError(f'loss_cls {loss_cls!r}: only the '
                                      "softmax classifier is ported")
        super().__init__(num_classes=num_classes, **kwargs)
        self.mask_size = mask_size
        self.mask_head = FCNMaskHead(
            num_classes=num_classes,
            in_channels=kwargs.get('neck_channels', 256),
            normed_predictor=normed_mask, dtype=self.dtype)

    def loss(self, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             sampler_priorities: Optional[Dict[str, torch.Tensor]] = None
             ) -> Dict[str, torch.Tensor]:
        """The RPN and box losses of `FasterRCNNFPN`, then the mask loss on
        the same sampled RoIs; each stage a `step/...` range."""
        return self._mask_losses(batch, generator, sampler_priorities)[0]

    def _mask_losses(self, batch, generator, sampler_priorities):
        """`loss`'s losses, and the mask branch that the mask variants'
        extra heads read (`MaskBranch`)."""
        gt_masks = batch_gt_masks(batch)
        losses, sampled, maps = self._det_losses(batch, generator,
                                                 sampler_priorities)
        with record_function('step/mask_roi_align_fwd'):
            feats = self.roi_extract(maps, sampled.rois,
                                     out_size=self.mask_size // 2,
                                     flatten=False)
        with record_function('step/mask_targets'):
            targets = mask_targets_from_box_frame(
                gt_masks, batch['gt_bboxes'], sampled.rois,
                sampled.matched_gt, self.mask_size)
        with record_function('step/mask_head_and_loss'):
            logits = self.mask_head(feats)
            pos_w = (sampled.is_pos & sampled.label_valid).float()
            losses.update(mask_loss(logits, targets, sampled.labels, pos_w))
        return losses, MaskBranch(maps, sampled, feats, logits, targets,
                                  pos_w)

    @torch.inference_mode()
    def predict(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """`FasterRCNNFPN.predict` plus `masks` (B, D, 28, 28): the sigmoid
        of each detection's class channel, for every row of `dets`."""
        out, maps = self._detect(batch)
        out['masks'] = self.mask_predict(maps, out)
        return out

    def mask_predict(self, maps, out: Dict[str, torch.Tensor]
                     ) -> torch.Tensor:
        """The mask branch on the detections of `out`: 14x14 RoIAlign,
        mask head, own-class sigmoid."""
        feats = self.roi_extract(maps, out['dets'][..., :4].contiguous(),
                                 out_size=self.mask_size // 2, flatten=False)
        return select_class_masks(self.mask_head(feats), out['labels'],
                                  self.num_classes)


def _pil_bilinear_taps(in_size: int, out_size: int) -> np.ndarray:
    """PIL's 8-bit bilinear resampling coefficients as a dense (out, in)
    float64 matrix of integers (fixed point, `_PIL_BITS` fraction bits):
    `precompute_coeffs` then `normalize_coeffs_8bpc` of Pillow's
    `Resample.c`, in double as there."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    mat = np.zeros((out_size, in_size), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = np.zeros(ksize)
        ww = 0.0
        for x in range(xmax):
            v = abs((x + xmin - center + 0.5) * ss)
            k[x] = 1.0 - v if v < 1.0 else 0.0
            ww += k[x]
        if ww != 0.0:
            k[:xmax] = k[:xmax] / ww
        fixed = np.where(k < 0, np.trunc(-0.5 + k * (1 << _PIL_BITS)),
                         np.trunc(0.5 + k * (1 << _PIL_BITS)))
        mat[xx, xmin:xmin + xmax] = fixed[:xmax]
    return mat


def _pil_pass(img: torch.Tensor, taps: np.ndarray, dim: int) -> torch.Tensor:
    """One fixed-point pass of an integer-valued float64 image along `dim`
    (0 = rows, 1 = columns): Σ pixel · coefficient + 2^(bits-1), shifted
    and clipped to 0..255. Every product and sum is an integer below 2^53,
    so float64 holds it exactly."""
    w = torch.as_tensor(taps, device=img.device)
    acc = w @ img if dim == 0 else img @ w.t()
    acc = torch.floor((acc + (1 << (_PIL_BITS - 1))) / (1 << _PIL_BITS))
    return acc.clamp(0, 255)


def paste_masks(masks: torch.Tensor, boxes, img_h: int, img_w: int,
                thr: float = 0.5) -> torch.Tensor:
    """Paste (D, m, m) mask probabilities into (D, img_h, img_w) booleans
    at their (D, 4) boxes (reference `FCNMaskHead.get_seg_masks`), on the
    masks' device. As the JAX package does it with PIL: each box rounds to
    whole pixels, its mask (probability · 255, truncated to uint8) resizes
    to the box with PIL's bilinear filter — two fixed-point passes,
    horizontal then vertical, with an 8-bit result after each, reproduced
    here in integers — and pixels >= thr · 255 inside the image are set."""
    masks = torch.as_tensor(masks)
    boxes = np.asarray(torch.as_tensor(boxes).detach().cpu(), np.float64)
    out = torch.zeros((len(masks), img_h, img_w), dtype=torch.bool,
                      device=masks.device)
    q = (masks.float() * 255).to(torch.uint8).double()
    m_h, m_w = q.shape[-2:]
    for i, box in enumerate(boxes):
        x1, y1, x2, y2 = (int(round(v)) for v in box)
        w, h = max(x2 - x1, 1), max(y2 - y1, 1)
        xs, ys = max(x1, 0), max(y1, 0)
        xe, ye = min(x2, img_w), min(y2, img_h)
        if xe <= xs or ye <= ys:
            continue
        resized = q[i]
        if w != m_w:
            resized = _pil_pass(resized, _pil_bilinear_taps(m_w, w), 1)
        if h != m_h:
            resized = _pil_pass(resized, _pil_bilinear_taps(m_h, h), 0)
        crop = resized[ys - y1:ye - y1, xs - x1:xe - x1]
        out[i, ys:ye, xs:xe] = crop >= thr * 255
    return out

