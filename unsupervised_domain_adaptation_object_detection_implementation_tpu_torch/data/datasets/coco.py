"""COCO-json dataset (counterpart of the JAX package's
`data/datasets/coco.py`): the json parsed without pycocotools, instance
polygons kept for `LoadAnnotations(with_mask=True)`, and two evaluations,
the VOC fallback ('mAP', which the training loop runs) and the COCO
protocol ('bbox': AP over IoU .50:.95 with 101-point precision, and the
small / medium / large area ranges), on the host in numpy.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List

import numpy as np

from ...utils.registry import DATASETS
from .custom import CustomDataset


@DATASETS.register_module()
class CocoDataset(CustomDataset):
    CLASSES = (
        'person', 'bicycle', 'car', 'motorcycle', 'airplane', 'bus', 'train',
        'truck', 'boat', 'traffic light', 'fire hydrant', 'stop sign',
        'parking meter', 'bench', 'bird', 'cat', 'dog', 'horse', 'sheep',
        'cow', 'elephant', 'bear', 'zebra', 'giraffe', 'backpack', 'umbrella',
        'handbag', 'tie', 'suitcase', 'frisbee', 'skis', 'snowboard',
        'sports ball', 'kite', 'baseball bat', 'baseball glove', 'skateboard',
        'surfboard', 'tennis racket', 'bottle', 'wine glass', 'cup', 'fork',
        'knife', 'spoon', 'bowl', 'banana', 'apple', 'sandwich', 'orange',
        'broccoli', 'carrot', 'hot dog', 'pizza', 'donut', 'cake', 'chair',
        'couch', 'potted plant', 'bed', 'dining table', 'toilet', 'tv',
        'laptop', 'mouse', 'remote', 'keyboard', 'cell phone', 'microwave',
        'oven', 'toaster', 'sink', 'refrigerator', 'book', 'clock', 'vase',
        'scissors', 'teddy bear', 'hair drier', 'toothbrush')

    def load_annotations(self, ann_file: str) -> List[dict]:
        """Per image: boxes xyxy from the json's xywh, labels, the crowd
        boxes as `bboxes_ignore` (with their labels), and each instance's
        polygons (`[]` for an RLE segmentation). Annotations marked
        `ignore`, or of a category outside the class table, are dropped.
        With `classes=` the table is that subset; without it, a json whose
        category count differs from the default table brings its own."""
        with open(ann_file) as f:
            coco = json.load(f)
        cats = sorted(coco['categories'], key=lambda c: c['id'])
        if not self.custom_classes and (
                not self.CLASSES or len(self.CLASSES) != len(cats)):
            self.CLASSES = tuple(c['name'] for c in cats)
            self.cat2label = {c: i for i, c in enumerate(self.CLASSES)}
        catid2label = {c['id']: self.cat2label[c['name']] for c in cats
                       if c['name'] in self.cat2label}
        anns_by_img = defaultdict(list)
        for a in coco.get('annotations', []):
            anns_by_img[a['image_id']].append(a)
        infos = []
        for img in coco['images']:
            bboxes, labels, masks = [], [], []
            bboxes_ignore, labels_ignore = [], []
            for a in anns_by_img[img['id']]:
                if a.get('ignore') or a['category_id'] not in catid2label:
                    continue
                x, y, w, h = a['bbox']
                box = [x, y, x + w, y + h]
                if a.get('iscrowd'):
                    bboxes_ignore.append(box)
                    labels_ignore.append(catid2label[a['category_id']])
                else:
                    bboxes.append(box)
                    labels.append(catid2label[a['category_id']])
                    seg = a.get('segmentation')
                    masks.append(seg if isinstance(seg, list) else [])
            infos.append(dict(
                id=img['id'], filename=img['file_name'],
                width=img['width'], height=img['height'],
                ann=dict(
                    bboxes=np.asarray(bboxes, np.float32).reshape(-1, 4),
                    labels=np.asarray(labels, np.int64),
                    bboxes_ignore=np.asarray(bboxes_ignore,
                                             np.float32).reshape(-1, 4),
                    labels_ignore=np.asarray(labels_ignore, np.int64),
                    masks=masks)))
        return infos

    def evaluate(self, results, metric: str = 'bbox',
                 **kwargs) -> Dict[str, float]:
        """'mAP': the VOC protocol with boxes measured `x2 - x1` wide (the
        loop's metric); 'bbox': the COCO protocol, `bbox_mAP` (IoU .50:.95),
        `bbox_mAP_50`, `bbox_mAP_75` and `bbox_mAP_{s,m,l}`."""
        if metric == 'mAP':
            return super().evaluate(results, metric='mAP',
                                    use_legacy_coordinate=False, **kwargs)
        if metric != 'bbox':
            raise KeyError(f'CocoDataset.evaluate: metric {metric!r} (mAP or '
                           'bbox)')
        annotations = [self.get_ann_info(i) for i in range(len(self))]
        iou_thrs = np.arange(0.5, 1.0, 0.05)
        n = len(self.CLASSES)
        aps = coco_style_ap(results, annotations, iou_thrs, n)
        out = {'bbox_mAP': float(np.mean(aps)),
               'bbox_mAP_50': float(aps[0]),
               'bbox_mAP_75': float(aps[5])}
        for key, rng in (('s', AREA_SMALL), ('m', AREA_MEDIUM),
                         ('l', AREA_LARGE)):
            out[f'bbox_mAP_{key}'] = float(np.mean(coco_style_ap(
                results, annotations, iou_thrs, n, area_rng=rng)))
        return out


# COCOeval's area ranges (pycocotools `Params.areaRng`)
AREA_ALL = (0.0, 1e10)
AREA_SMALL = (0.0, 32.0 ** 2)
AREA_MEDIUM = (32.0 ** 2, 96.0 ** 2)
AREA_LARGE = (96.0 ** 2, 1e10)


def _coco_ious(d: np.ndarray, g: np.ndarray,
               iscrowd: np.ndarray) -> np.ndarray:
    """det x gt IoU; against a crowd gt the union is the det's area."""
    if len(d) == 0 or len(g) == 0:
        return np.zeros((len(d), len(g)))
    lt = np.maximum(d[:, None, :2], g[None, :, :2])
    rb = np.minimum(d[:, None, 2:4], g[None, :, 2:4])
    wh = np.maximum(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    da = ((d[:, 2] - d[:, 0]) * (d[:, 3] - d[:, 1]))[:, None]
    ga = ((g[:, 2] - g[:, 0]) * (g[:, 3] - g[:, 1]))[None, :]
    union = np.where(iscrowd[None, :], da, da + ga - inter)
    return inter / np.maximum(union, np.finfo(np.float64).eps)


def _match_one_image(d, g, iscrowd, gt_ig, iou_thrs, max_dets):
    """COCOeval's matching of one image and class: the top `max_dets` dets
    by a stable score sort take, at each threshold, the best-IoU gt not
    taken yet (crowd gts may be taken again; ignored gts sort last and do
    not displace a match). Returns (scores, matched (T, n), ignored (T, n))."""
    order = np.argsort(-d[:, -1], kind='mergesort')[:max_dets]
    d = d[order]
    gt_order = np.argsort(gt_ig, kind='mergesort')
    g, iscrowd, gt_ig = g[gt_order], iscrowd[gt_order], gt_ig[gt_order]
    ious = _coco_ious(d[:, :4], g, iscrowd)
    n, m = len(d), len(g)
    dtm = np.zeros((len(iou_thrs), n), bool)
    dt_ig = np.zeros((len(iou_thrs), n), bool)
    for t, thr in enumerate(iou_thrs):
        gtm = np.zeros(m, bool)
        for i in range(n):
            best = min(thr, 1 - 1e-10)
            match = -1
            for j in range(m):
                if gtm[j] and not iscrowd[j]:
                    continue
                if match > -1 and not gt_ig[match] and gt_ig[j]:
                    break
                if ious[i, j] < best:
                    continue
                best = ious[i, j]
                match = j
            if match == -1:
                continue
            dtm[t, i] = True
            dt_ig[t, i] = gt_ig[match]
            gtm[match] = True
    return d[:, -1], dtm, dt_ig


def coco_style_ap(det_results, annotations, iou_thrs, num_classes,
                  max_dets: int = 100, area_rng=None) -> np.ndarray:
    """COCO AP at each IoU threshold (pycocotools' evaluateImg and
    accumulate): crowd boxes of the class are reusable ignore regions, gts
    outside `area_rng` are ignored and so are the unmatched dets outside
    it, precision is interpolated at 101 recall points, and classes
    without a gt that counts are left out of the mean."""
    iou_thrs = np.asarray(iou_thrs, np.float64)
    lo, hi = area_rng if area_rng is not None else AREA_ALL
    recall_thrs = np.linspace(0, 1, 101)
    n_thr = len(iou_thrs)
    aps = np.full((n_thr, num_classes), -1.0)
    for c in range(num_classes):
        scores, dtm_parts, dtig_parts = [], [], []
        npig = 0
        for det, ann in zip(det_results, annotations):
            d = np.asarray(det[c], np.float64).reshape(-1, 5)
            g = np.asarray(ann['bboxes'][ann['labels'] == c],
                           np.float64).reshape(-1, 4)
            g_ign = np.asarray(ann.get('bboxes_ignore', np.zeros((0, 4))),
                               np.float64).reshape(-1, 4)
            l_ign = ann.get('labels_ignore')
            if l_ign is not None and len(l_ign) == len(g_ign):
                g_ign = g_ign[np.asarray(l_ign) == c]
            gall = np.concatenate([g, g_ign], axis=0)
            iscrowd = np.concatenate([np.zeros(len(g), bool),
                                      np.ones(len(g_ign), bool)])
            area = (gall[:, 2] - gall[:, 0]) * (gall[:, 3] - gall[:, 1])
            gt_ig = iscrowd | (area < lo) | (area > hi)
            s, dtm, dt_ig = _match_one_image(d, gall, iscrowd, gt_ig,
                                             iou_thrs, max_dets)
            darea = (d[:, 2] - d[:, 0]) * (d[:, 3] - d[:, 1])
            dorder = np.argsort(-d[:, -1], kind='mergesort')[:max_dets]
            out_rng = (darea[dorder] < lo) | (darea[dorder] > hi)
            dt_ig = dt_ig | (~dtm & out_rng[None, :])
            scores.append(s)
            dtm_parts.append(dtm)
            dtig_parts.append(dt_ig)
            npig += int((~gt_ig).sum())
        if npig == 0:
            continue
        order = np.argsort(-np.concatenate(scores), kind='mergesort')
        dtm = np.concatenate(dtm_parts, axis=1)[:, order]
        dt_ig = np.concatenate(dtig_parts, axis=1)[:, order]
        tps = np.cumsum(dtm & ~dt_ig, axis=1, dtype=np.float64)
        fps = np.cumsum(~dtm & ~dt_ig, axis=1, dtype=np.float64)
        for t in range(n_thr):
            tp, fp = tps[t], fps[t]
            rc = tp / npig
            pr = tp / (fp + tp + np.spacing(1))
            q = np.zeros(len(recall_thrs))
            # the monotone envelope, right to left
            for i in range(len(pr) - 1, 0, -1):
                if pr[i] > pr[i - 1]:
                    pr[i - 1] = pr[i]
            inds = np.searchsorted(rc, recall_thrs, side='left')
            valid = inds < len(pr)
            q[valid] = pr[inds[valid]]
            aps[t, c] = q.mean()
    has = aps[0] > -1
    if not has.any():
        return np.zeros(n_thr)
    return aps[:, has].mean(axis=1)
