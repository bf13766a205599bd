"""Evaluation API (counterpart of the JAX package's `apis/test.py`, without
test-time augmentation).

`run_inference` runs `model.predict` over a dataset in batches, on the
dataset's device, and converts the padded outputs to per-image, per-class
(n, 5) numpy arrays in original image coordinates; `evaluate_dataset` feeds
them to `dataset.evaluate`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core.bbox.transforms import bbox2result
from ..data import DataLoader
from ..parallel.mesh import Layout


def results_from_batch(dets: np.ndarray, labels: np.ndarray,
                       valid: np.ndarray, scale_factor: np.ndarray,
                       num_classes: int) -> List[List[np.ndarray]]:
    """Padded `predict` outputs → per image, per class (n, 5) arrays in
    original coordinates."""
    out = []
    for i in range(dets.shape[0]):
        boxes = dets[i, :, :4] / scale_factor[i]
        out.append(bbox2result(boxes, labels[i], dets[i, :, 4], valid[i],
                               num_classes))
    return out


def run_inference(model, dataset, samples_per_batch: int = 2,
                  flip_tta: bool = False, scale_tta: Sequence[float] = (),
                  layout: Optional[Layout] = None) -> List[List[np.ndarray]]:
    """Detections of `model` (in eval mode, weights as they stand) on every
    image of `dataset`, in order; the last batch is filled up with images
    from the start and the surplus dropped. With a `layout` of several
    ranks on the data axis, batches of `samples_per_batch` a rank are
    split over it, as the JAX package shards an evaluation batch over its
    mesh, and every rank returns every image's detections (the ranks of a
    model axis run their batches together). Test-time augmentation is not
    ported: `flip_tta` or `scale_tta` raise."""
    if flip_tta or scale_tta:
        raise NotImplementedError('test-time augmentation (flip_tta, '
                                  'scale_tta) is not ported yet')
    dp = layout.data if layout is not None and layout.data.size > 1 \
        else None
    per = samples_per_batch
    loader = DataLoader(dataset, per * (dp.size if dp else 1), shuffle=False,
                        two_stream=False, drop_last=False,
                        rows=(dp.rank * per, (dp.rank + 1) * per) if dp
                        else None)
    results: List[List[np.ndarray]] = []
    n = len(dataset)
    with torch.no_grad():
        for batch in loader:
            out = {k: v.cpu().numpy() for k, v in model.predict(batch).items()}
            got = results_from_batch(out['dets'], out['labels'], out['valid'],
                                     batch['scale_factor'].cpu().numpy(),
                                     model.num_classes)
            if dp is not None:
                parts = [None] * dp.size
                dist.all_gather_object(parts, got, group=dp.group)
                got = [r for part in parts for r in part]
            results.extend(got[:n - len(results)])
    return results


def evaluate_dataset(model, dataset, samples_per_batch: int = 2,
                     metric: str = 'mAP', layout: Optional[Layout] = None
                     ) -> Dict[str, float]:
    """`dataset.evaluate` of `run_inference`'s detections (split over the
    data axis of `layout`, when given)."""
    results = run_inference(model, dataset, samples_per_batch, layout=layout)
    return dataset.evaluate(results, metric=metric)
