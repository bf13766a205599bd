"""RoI head inference (counterpart of the JAX package's
`models/roi_heads/standard_roi_head.py`: `extract_roi_feats` and
`roi_head_predict`)."""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from ...core.bbox.transforms import delta2bbox
from ...core.post.nms import multiclass_nms
from ...ops.roi_align import batched_roi_align


class RoITrainConfig(NamedTuple):
    """The RoI head's box-coder and classifier settings. Inference reads
    `target_stds` and `use_sigmoid_cls`; the sampling fields come with the
    training slice."""
    target_stds: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)
    use_sigmoid_cls: bool = True


class RoITestConfig(NamedTuple):
    score_thr: float = 0.05
    nms_iou_threshold: float = 0.5
    max_per_img: int = 100
    nms_pre: int = 1024
    nms_tile: int = 256
    nms_type: str = 'nms'


def extract_roi_feats(feats: torch.Tensor, rois: torch.Tensor,
                      featmap_stride: int = 16, out_size: int = 7,
                      sampling_ratio: int = 2,
                      flatten: bool = False) -> torch.Tensor:
    """`SingleRoIExtractor` for the single-level DC5 trunk: feats
    (B, H, W, C) NHWC, rois (B, R, 4) → (B, R, o, o, C) or (B, R, o·o·C)
    x-major. On a card this launches the CUDA RoIAlign kernel."""
    return batched_roi_align(feats, rois, 1.0 / featmap_stride, out_size,
                             sampling_ratio, flatten=flatten)


def roi_head_predict(bbox_head_apply: Callable,
                     feats: torch.Tensor,
                     proposals: torch.Tensor,
                     prop_valid: torch.Tensor,
                     img_shape: torch.Tensor,
                     num_classes: int,
                     featmap_stride: int = 16,
                     reg_class_agnostic: bool = False,
                     target_stds: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2),
                     use_sigmoid_cls: bool = True,
                     cfg: RoITestConfig = RoITestConfig()
                     ) -> Dict[str, torch.Tensor]:
    """RoIAlign → bbox head → decode → clip → `multiclass_nms`.

    A sigmoid head gets a synthesized zero background column; scores of
    padded proposals are zeroed by `prop_valid`; boxes are clipped to each
    image's (w, h, w, h). Returns dict(dets (B, max, 5), labels (B, max),
    valid (B, max)).
    """
    roi_feats = extract_roi_feats(feats, proposals, featmap_stride,
                                  flatten=True)
    cls, reg, _ = bbox_head_apply(roi_feats)
    cls = cls.float()
    reg = reg.float()
    if use_sigmoid_cls:
        probs = torch.sigmoid(cls)[..., :num_classes]
        scores = torch.cat([probs, torch.zeros_like(probs[..., :1])], dim=-1)
    else:
        scores = torch.softmax(cls, dim=-1)
    scores = scores * prop_valid[..., None]

    b, p = proposals.shape[:2]
    if reg_class_agnostic:
        dec = delta2bbox(proposals, reg.reshape(b, p, 4), stds=target_stds)
        boxes = dec[:, :, None, :].expand(b, p, num_classes, 4)
    else:
        boxes = delta2bbox(
            proposals[:, :, None, :].expand(b, p, num_classes, 4),
            reg.reshape(b, p, num_classes, 4), stds=target_stds)
    hw = img_shape.to(boxes.dtype)
    upper = torch.stack([hw[:, 1], hw[:, 0], hw[:, 1], hw[:, 0]],
                        dim=-1)[:, None, None, :]
    boxes = torch.minimum(torch.maximum(boxes, boxes.new_zeros(())), upper)

    dets, labels, valid = multiclass_nms(
        boxes.reshape(b, p, num_classes * 4), scores, cfg.score_thr,
        cfg.nms_iou_threshold, cfg.max_per_img, cfg.nms_tile, cfg.nms_pre,
        nms_type=cfg.nms_type)
    return dict(dets=dets, labels=labels, valid=valid)
