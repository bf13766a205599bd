"""Helpers of the multi-level dense heads (counterpart of the JAX package's
`models/dense_heads/anchor_head.py`): `flatten_level_preds` and the
single-stage test path `dense_anchor_predict`. The single-stage heads and
`anchor_head_loss` are not ported yet."""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from ...core.bbox.transforms import clip_boxes, delta2bbox
from ...core.post.nms import NEG_INF, batched_nms, topk_stable


def flatten_level_preds(preds: Sequence[torch.Tensor], channels: int
                        ) -> torch.Tensor:
    """[(B, H_i, W_i, A*channels)] NHWC → (B, ΣH_i·W_i·A, channels), each
    level location-major, anchor-minor, the levels in order."""
    b = preds[0].shape[0]
    return torch.cat([p.reshape(b, -1, channels) for p in preds], dim=1)


class DensePredictConfig(NamedTuple):
    nms_pre: int = 1000
    score_thr: float = 0.05
    nms_iou_threshold: float = 0.5
    max_per_img: int = 100
    nms_tile: int = 256
    target_stds: Tuple[float, ...] = (1., 1., 1., 1.)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, D), idx (B, K) → (B, K, D)."""
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def dense_anchor_predict(cls_logits: torch.Tensor,
                         reg_preds: torch.Tensor,
                         anchors: torch.Tensor,
                         img_shape: torch.Tensor,
                         num_classes: int,
                         cfg: DensePredictConfig = DensePredictConfig()
                         ) -> Dict[str, torch.Tensor]:
    """The single-stage test path: per image, the top `nms_pre` of the
    anchor x class sigmoid scores over `score_thr` (the rest at NEG_INF,
    ties to the lower flat index), decoded at `target_stds`, clipped, then
    class-aware NMS and the top `max_per_img`. cls_logits (B, N, C),
    reg_preds (B, N, 4), anchors (N, 4) or per image (B, N, 4), img_shape
    (B, 2) → dict(dets (B, M, 5), labels (B, M), valid (B, M)), zeroed
    past the valid rows."""
    b = cls_logits.shape[0]
    probs = torch.sigmoid(cls_logits.float())
    flat = probs.reshape(b, -1)
    flat = torch.where(flat > cfg.score_thr, flat, flat.new_tensor(NEG_INF))
    k = min(cfg.nms_pre, flat.shape[-1])
    top, idx = topk_stable(flat, k)
    a_idx = idx // num_classes
    labels = idx % num_classes
    if anchors.dim() == 2:
        anchors = anchors.expand(b, *anchors.shape)
    boxes = delta2bbox(_rows(anchors, a_idx), _rows(reg_preds.float(), a_idx),
                       stds=cfg.target_stds)
    boxes = clip_boxes(boxes, img_shape[:, None, :].to(boxes.dtype))
    keep, _ = batched_nms(boxes, top, labels, cfg.nms_iou_threshold,
                          cfg.nms_tile)
    kept = torch.where(keep, top, top.new_tensor(NEG_INF))
    m = min(cfg.max_per_img, k)
    sc, sel = topk_stable(kept, m)
    valid = sc > NEG_INF / 2
    dets = torch.cat([_rows(boxes, sel) * valid[..., None],
                      torch.where(valid, sc, sc.new_zeros(()))[..., None]],
                     dim=-1)
    out_labels = torch.where(valid, torch.gather(labels, 1, sel),
                             torch.zeros_like(sel))
    return dict(dets=dets, labels=out_labels, valid=valid)
