"""VOC-protocol detection mAP and proposal recall (counterpart of the JAX
package's `core/eval/mean_ap.py`, its numpy path; the C++ matcher is not
ported).

Host-side numpy on ragged per-image, per-class (n, 5) [x1, y1, x2, y2,
score] arrays. `use_legacy_coordinate=True`, which the DA datasets evaluate
with, measures a box as `x2 - x1 + 1` wide.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np


def average_precision(recalls: np.ndarray, precisions: np.ndarray,
                      mode: str = 'area') -> Union[float, np.ndarray]:
    """AP of a recall/precision curve (1-D, or one row per scale): 'area'
    (VOC2010+, the area under the monotone precision envelope) or
    '11points' (VOC2007)."""
    recalls = recalls[None, :] if recalls.ndim == 1 else recalls
    precisions = precisions[None, :] if precisions.ndim == 1 else precisions
    num_scales = recalls.shape[0]
    ap = np.zeros(num_scales, dtype=np.float64)
    if mode == 'area':
        zeros = np.zeros((num_scales, 1))
        ones = np.ones((num_scales, 1))
        mrec = np.hstack((zeros, recalls, ones))
        mpre = np.hstack((zeros, precisions, zeros))
        for i in range(mpre.shape[1] - 1, 0, -1):
            mpre[:, i - 1] = np.maximum(mpre[:, i - 1], mpre[:, i])
        for i in range(num_scales):
            ind = np.where(mrec[i, 1:] != mrec[i, :-1])[0]
            ap[i] = np.sum((mrec[i, ind + 1] - mrec[i, ind]) * mpre[i, ind + 1])
    elif mode == '11points':
        for i in range(num_scales):
            for thr in np.arange(0, 1 + 1e-3, 0.1):
                precs = precisions[i, recalls[i, :] >= thr]
                ap[i] += precs.max() if precs.size > 0 else 0
        ap /= 11
    else:
        raise ValueError(mode)
    return ap if num_scales > 1 else float(ap[0])


def _overlaps(boxes1: np.ndarray, boxes2: np.ndarray,
              extra: float) -> np.ndarray:
    """Pairwise IoU, lengths measured as `x2 - x1 + extra`."""
    if boxes1.size == 0 or boxes2.size == 0:
        return np.zeros((boxes1.shape[0], boxes2.shape[0]))
    lt = np.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = np.minimum(boxes1[:, None, 2:4], boxes2[None, :, 2:4])
    wh = np.maximum(rb - lt + extra, 0)
    inter = wh[..., 0] * wh[..., 1]
    a1 = ((boxes1[:, 2] - boxes1[:, 0] + extra) *
          (boxes1[:, 3] - boxes1[:, 1] + extra))[:, None]
    a2 = ((boxes2[:, 2] - boxes2[:, 0] + extra) *
          (boxes2[:, 3] - boxes2[:, 1] + extra))[None, :]
    return inter / np.maximum(a1 + a2 - inter, np.finfo(np.float64).eps)


def tpfp_default(det_bboxes: np.ndarray,
                 gt_bboxes: np.ndarray,
                 gt_bboxes_ignore: Optional[np.ndarray] = None,
                 iou_thr: float = 0.5,
                 use_legacy_coordinate: bool = False
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy TP/FP marks of one image's detections of one class, in
    descending score order: a detection whose best gt reaches `iou_thr` is a
    TP if that gt is still free, else an FP; one that reaches only an
    ignored gt is neither."""
    extra = 1.0 if use_legacy_coordinate else 0.0
    gt_ignore = gt_bboxes_ignore if gt_bboxes_ignore is not None else \
        np.zeros((0, 4))
    num_dets = det_bboxes.shape[0]
    num_gts = gt_bboxes.shape[0]
    tp = np.zeros(num_dets)
    fp = np.zeros(num_dets)
    if num_gts == 0 and gt_ignore.shape[0] == 0:
        fp[...] = 1
        return tp, fp
    if num_dets == 0:
        return tp, fp
    ious = _overlaps(det_bboxes[:, :4], gt_bboxes, extra)
    ious_max = ious.max(axis=1) if num_gts else np.zeros(num_dets)
    ious_argmax = ious.argmax(axis=1) if num_gts else np.zeros(num_dets, int)
    sort_inds = np.argsort(-det_bboxes[:, -1])
    gt_covered = np.zeros(num_gts, bool)
    ign_ious = _overlaps(det_bboxes[:, :4], gt_ignore, extra) \
        if gt_ignore.shape[0] else None
    for i in sort_inds:
        if num_gts and ious_max[i] >= iou_thr:
            m = ious_argmax[i]
            if not gt_covered[m]:
                gt_covered[m] = True
                tp[i] = 1
            else:
                fp[i] = 1
        else:
            if ign_ious is not None and ign_ious[i].max() >= iou_thr:
                continue
            fp[i] = 1
    return tp, fp


def eval_map(det_results: List[List[np.ndarray]],
             annotations: List[Dict],
             iou_thr: float = 0.5,
             dataset: Optional[str] = None,
             use_legacy_coordinate: bool = False,
             mode: Optional[str] = None) -> Tuple[float, List[Dict]]:
    """Mean AP over the classes that have gts.

    `det_results`: per image, per class (n, 5) arrays; `annotations`: per
    image dicts of 'bboxes' (n, 4), 'labels' (n,) and optionally
    'bboxes_ignore' / 'labels_ignore'. `dataset='voc07'` selects the
    11-point AP, else the area (an explicit `mode` overrides). Returns
    (mean AP, per class dicts of num_gts, num_dets, recall, precision,
    ap)."""
    if len(det_results) != len(annotations):
        raise ValueError(f'{len(det_results)} results for '
                         f'{len(annotations)} images')
    num_classes = len(det_results[0])
    if mode is None:
        mode = '11points' if dataset == 'voc07' else 'area'

    eval_results = []
    for c in range(num_classes):
        cls_dets = [det[c] for det in det_results]
        cls_gts, cls_gts_ignore = [], []
        for ann in annotations:
            cls_gts.append(ann['bboxes'][ann['labels'] == c, :4])
            if ann.get('labels_ignore') is not None and \
                    ann.get('bboxes_ignore') is not None and \
                    len(ann['bboxes_ignore']):
                ig_inds = ann['labels_ignore'] == c
                cls_gts_ignore.append(ann['bboxes_ignore'][ig_inds, :4])
            else:
                cls_gts_ignore.append(np.zeros((0, 4)))

        tpfp = [tpfp_default(d, g, gi, iou_thr, use_legacy_coordinate)
                for d, g, gi in zip(cls_dets, cls_gts, cls_gts_ignore)]
        tp_list, fp_list = zip(*tpfp) if tpfp else ([], [])
        num_gts = sum(g.shape[0] for g in cls_gts)
        all_dets = np.vstack(cls_dets) if cls_dets else np.zeros((0, 5))
        num_dets = all_dets.shape[0]
        sort_inds = np.argsort(-all_dets[:, -1]) if num_dets else \
            np.array([], int)
        tp = np.concatenate(tp_list)[sort_inds] if num_dets else np.array([])
        fp = np.concatenate(fp_list)[sort_inds] if num_dets else np.array([])
        tp_cum = np.cumsum(tp)
        fp_cum = np.cumsum(fp)
        eps = np.finfo(np.float64).eps
        recalls = tp_cum / max(num_gts, eps)
        precisions = tp_cum / np.maximum(tp_cum + fp_cum, eps)
        ap = average_precision(recalls, precisions, mode) if num_dets else 0.0
        eval_results.append(dict(
            num_gts=num_gts, num_dets=num_dets,
            recall=recalls, precision=precisions, ap=float(ap)))

    aps = [r['ap'] for r in eval_results if r['num_gts'] > 0]
    mean_ap = float(np.mean(aps)) if aps else 0.0
    return mean_ap, eval_results


def eval_recalls(gts: List[np.ndarray],
                 proposals: List[np.ndarray],
                 proposal_nums: Sequence[int] = (100, 300, 1000),
                 iou_thrs: Sequence[float] = (0.5,),
                 use_legacy_coordinate: bool = False) -> np.ndarray:
    """(len(proposal_nums), len(iou_thrs)) recall: the share of gts that
    one of the image's top-scored proposals reaches at the threshold."""
    extra = 1.0 if use_legacy_coordinate else 0.0
    proposal_nums = np.array(proposal_nums)
    iou_thrs = np.array(iou_thrs, dtype=np.float64)
    recalls = np.zeros((len(proposal_nums), len(iou_thrs)))
    total_gt = sum(g.shape[0] for g in gts)
    if total_gt == 0:
        return recalls
    for k, pn in enumerate(proposal_nums):
        for t, thr in enumerate(iou_thrs):
            hit = 0
            for gt, prop in zip(gts, proposals):
                if gt.shape[0] == 0 or prop.shape[0] == 0:
                    continue
                p = prop[np.argsort(-prop[:, -1])][:pn]
                ious = _overlaps(gt, p[:, :4], extra)
                hit += int((ious.max(axis=1) >= thr).sum())
            recalls[k, t] = hit / total_gt
    return recalls
