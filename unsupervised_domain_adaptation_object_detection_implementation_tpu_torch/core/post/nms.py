"""Exact greedy NMS with static, padded outputs (torch counterpart of the
JAX package's `core/post/nms.py`, hard NMS only).

Same algorithm as the reference, so the keep sets agree exactly:

- boxes are sorted by score once (stable, ties to the lower index — what
  `jnp.argsort` and `lax.top_k` do; `torch.topk` promises neither, so every
  selection here goes through :func:`topk_stable`);
- they are processed in fixed-size tiles: each tile is first suppressed by
  all earlier (already final) tiles, then resolved internally by iterating
  the upper-triangular suppression matrix to its fixpoint, which is the
  sequential greedy result.

Every function takes leading batch dims, so one call serves a whole batch.
On a card the fixpoint loop reads one flag back to the host per iteration;
that sync is the price of the exact semantics in plain torch.

Entries whose score is `NEG_INF` (or below `NEG_INF / 2`) are invalid: they
neither survive nor suppress. Outputs are zero-padded with validity masks.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..bbox.iou import bbox_overlaps

NEG_INF = -1e10


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-`k` along the last dim, descending, ties to the lower index
    (the `lax.top_k` order)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _gather_boxes(boxes: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """boxes (..., N, 4), idx (..., K) → (..., K, 4)."""
    return torch.gather(boxes, -2, idx[..., None].expand(*idx.shape, 4))


def nms(boxes: torch.Tensor,
        scores: torch.Tensor,
        iou_threshold: float,
        tile_size: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact greedy NMS over the last axis.

    Args:
        boxes: (..., N, 4) xyxy.
        scores: (..., N); entries at NEG_INF are invalid.
        iou_threshold: a box is suppressed by a kept, higher-ranked box when
            their IoU is strictly greater than this.
        tile_size: processing tile.

    Returns:
        keep: (..., N) bool, kept boxes in the ORIGINAL input order.
        order: (..., N) int64, indices sorting scores descending.
    """
    n = boxes.shape[-2]
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    boxes_s = _gather_boxes(boxes, order)
    valid_s = torch.gather(scores, -1, order) > NEG_INF / 2

    pad = (-n) % tile_size
    boxes_p = torch.nn.functional.pad(boxes_s, (0, 0, 0, pad))
    alive = torch.nn.functional.pad(valid_s, (0, pad), value=False)
    num_tiles = alive.shape[-1] // tile_size
    upper = torch.ones(tile_size, tile_size, dtype=torch.bool,
                       device=boxes.device).triu(1)

    for i in range(num_tiles):
        lo, hi = i * tile_size, (i + 1) * tile_size
        tile_boxes = boxes_p[..., lo:hi, :]
        tile_alive = alive[..., lo:hi]
        if i:
            # suppression by every earlier tile's (final) survivors
            iou = bbox_overlaps(tile_boxes, boxes_p[..., :lo, :])
            sup = ((iou > iou_threshold) & alive[..., None, :lo]).any(-1)
            tile_alive = tile_alive & ~sup
        # self-suppression: row r may suppress col c only if r < c and r
        # survives; iterate from "nothing self-suppressed" to the fixpoint
        sup_matrix = (bbox_overlaps(tile_boxes, tile_boxes)
                      > iou_threshold) & upper
        a = tile_alive
        while True:
            new_a = tile_alive & ~(sup_matrix & a[..., :, None]).any(-2)
            if torch.equal(new_a, a):
                break
            a = new_a
        alive[..., lo:hi] = a

    keep_sorted = alive[..., :n] & valid_s
    keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    return keep, order


def batched_nms(boxes: torch.Tensor,
                scores: torch.Tensor,
                idxs: torch.Tensor,
                iou_threshold: float,
                tile_size: int = 256,
                class_agnostic: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Category-aware NMS via the coordinate-offset trick (mmcv
    `batched_nms`): boxes of different `idxs` never overlap after shifting,
    so one NMS call handles all categories. `lo` is the minimum over all of
    a row's boxes, valid or not, as in the reference."""
    if class_agnostic:
        return nms(boxes, scores, iou_threshold, tile_size)
    lo = boxes.amin(dim=(-2, -1), keepdim=True)
    unit = boxes.amax(dim=(-2, -1), keepdim=True) - lo + 1.0
    offsets = idxs.to(boxes.dtype)[..., None] * (unit + 1.0)
    shifted = (boxes - lo) + offsets
    return nms(shifted, scores, iou_threshold, tile_size)


def multiclass_nms(multi_bboxes: torch.Tensor,
                   multi_scores: torch.Tensor,
                   score_thr: float,
                   iou_threshold: float,
                   max_per_img: int,
                   tile_size: int = 256,
                   pre_nms_top_n: int = 0,
                   nms_type: str = 'nms'):
    """Per-class NMS over RCNN outputs (reference `multiclass_nms`).

    Args:
        multi_bboxes: (..., N, C*4) class-specific or (..., N, 4) shared.
        multi_scores: (..., N, C+1); the last column is background, dropped.
        pre_nms_top_n: cap on candidates entering NMS (0 = N*C).
        nms_type: only 'nms' (hard greedy) in this port so far.

    Returns:
        dets (..., max_per_img, 5) [x1 y1 x2 y2 score], labels
        (..., max_per_img) int64, valid (..., max_per_img) bool — descending
        score, zero-padded. The flat candidate order is class-minor
        (box-major), as in the reference.
    """
    if nms_type != 'nms':
        raise NotImplementedError(f'nms_type {nms_type!r}: only hard NMS '
                                  'is ported')
    batch = multi_scores.shape[:-2]
    n = multi_scores.shape[-2]
    num_classes = multi_scores.shape[-1] - 1
    scores = multi_scores[..., :num_classes]
    if multi_bboxes.shape[-1] == 4:
        boxes = multi_bboxes[..., :, None, :].expand(
            *batch, n, num_classes, 4)
    else:
        boxes = multi_bboxes.reshape(*batch, n, num_classes, 4)

    flat_boxes = boxes.reshape(*batch, n * num_classes, 4)
    flat_scores = scores.reshape(*batch, n * num_classes)
    flat_labels = torch.arange(num_classes, device=scores.device).repeat(n)
    flat_labels = flat_labels.expand(*batch, n * num_classes)
    flat_scores = torch.where(flat_scores > score_thr, flat_scores,
                              flat_scores.new_tensor(NEG_INF))

    if pre_nms_top_n and pre_nms_top_n < flat_scores.shape[-1]:
        flat_scores, sel = topk_stable(flat_scores, pre_nms_top_n)
        flat_boxes = _gather_boxes(flat_boxes, sel)
        flat_labels = torch.gather(flat_labels, -1, sel)

    keep, _ = batched_nms(flat_boxes, flat_scores, flat_labels, iou_threshold,
                          tile_size)
    kept_scores = torch.where(keep, flat_scores,
                              flat_scores.new_tensor(NEG_INF))
    k = min(max_per_img, kept_scores.shape[-1])
    top_scores, top_idx = topk_stable(kept_scores, k)
    if k < max_per_img:
        pad = max_per_img - k
        top_scores = torch.nn.functional.pad(top_scores, (0, pad),
                                             value=NEG_INF)
        top_idx = torch.nn.functional.pad(top_idx, (0, pad))
    valid = top_scores > NEG_INF / 2
    out_boxes = _gather_boxes(flat_boxes, top_idx) * valid[..., None]
    out_scores = torch.where(valid, top_scores, top_scores.new_zeros(()))
    out_labels = torch.where(valid, torch.gather(flat_labels, -1, top_idx),
                             top_idx.new_zeros(()))
    dets = torch.cat([out_boxes, out_scores[..., None]], dim=-1)
    return dets, out_labels, valid
