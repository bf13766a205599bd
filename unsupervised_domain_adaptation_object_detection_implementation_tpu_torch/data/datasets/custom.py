"""Base dataset (counterpart of the JAX package's
`data/datasets/custom.py`).

Holds an annotation index, runs the transform pipeline per item and
evaluates results with the VOC protocol. A `domain` kwarg tags every sample
('source' → 0, 'target' → 1). Each dataset draws its random transforms from
its own `np.random.RandomState(seed)`, handed to the pipeline as `_rng`, so
its draws follow the JAX package's one for one. Samples are made on
`device` (CUDA unless the caller asks for the CPU; raises without a card):
the image is decoded on the host, then resized, normalised and padded on
`device`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ...core.eval import eval_map, eval_recalls
from ...utils.device import resolve_device
from ...utils.registry import DATASETS
from ..pipelines.transforms import Compose


@DATASETS.register_module()
class CustomDataset:
    CLASSES: Sequence[str] = ()

    def __init__(self,
                 ann_file: str,
                 pipeline: Sequence[dict],
                 classes: Optional[Sequence[str]] = None,
                 img_prefix: str = '',
                 test_mode: bool = False,
                 filter_empty_gt: bool = True,
                 domain: Optional[str] = None,
                 seed: int = 0,
                 device: Union[str, torch.device] = 'cuda'):
        self.ann_file = ann_file
        self.img_prefix = img_prefix
        self.test_mode = test_mode
        self.filter_empty_gt = filter_empty_gt
        self.domain = {'source': 0, 'target': 1, None: 0}[domain]
        self.device = resolve_device(device)
        # an explicit `classes=` is the class table (a COCO json's
        # annotations are filtered to it)
        self.custom_classes = classes is not None
        if classes is not None:
            self.CLASSES = tuple(classes)
        self.cat2label = {c: i for i, c in enumerate(self.CLASSES)}
        self.data_infos = self.load_annotations(ann_file)
        if not test_mode and filter_empty_gt:
            self.data_infos = [
                info for info in self.data_infos
                if len(self.get_ann_info_of(info)['labels']) > 0
            ]
        self.pipeline = Compose(pipeline)
        self._rng = np.random.RandomState(seed)

    def load_annotations(self, ann_file: str) -> List[dict]:
        raise NotImplementedError

    def get_ann_info_of(self, info: dict) -> dict:
        """dict(bboxes (n, 4), labels (n,), bboxes_ignore, labels_ignore)."""
        return info['ann']

    def __len__(self):
        return len(self.data_infos)

    def get_ann_info(self, idx: int) -> dict:
        return self.get_ann_info_of(self.data_infos[idx])

    def __getitem__(self, idx: int):
        info = self.data_infos[idx]
        return self.pipeline(dict(
            img_info=info,
            ann_info=self.get_ann_info_of(info),
            img_prefix=self.img_prefix,
            domain=self.domain,
            device=self.device,
            _rng=self._rng,
        ))

    def evaluate(self,
                 results: List[List[np.ndarray]],
                 metric: str = 'mAP',
                 iou_thr: Union[float, Sequence[float]] = 0.5,
                 use_legacy_coordinate: bool = True,
                 proposal_nums=(100, 300, 1000)) -> Dict[str, float]:
        """VOC-protocol metrics of per-image, per-class (n, 5) results:
        'mAP' gives `AP50` (rounded to 4 places, one per threshold) and
        `mAP`; 'recall' gives `recall@N` for each proposal count."""
        annotations = [self.get_ann_info(i) for i in range(len(self))]
        out: Dict[str, float] = {}
        if metric == 'mAP':
            iou_thrs = [iou_thr] if isinstance(iou_thr, float) \
                else list(iou_thr)
            aps = []
            for thr in iou_thrs:
                mean_ap, _ = eval_map(
                    results, annotations, iou_thr=thr,
                    dataset='voc07' if getattr(self, 'year', None) == 2007
                    else None,
                    use_legacy_coordinate=use_legacy_coordinate)
                out[f'AP{int(thr * 100):02d}'] = round(mean_ap, 4)
                aps.append(mean_ap)
            out['mAP'] = sum(aps) / len(aps)
        elif metric == 'recall':
            gts = [a['bboxes'] for a in annotations]
            props = [np.vstack(r) for r in results]
            rec = eval_recalls(gts, props, proposal_nums, [iou_thr],
                               use_legacy_coordinate)
            for i, num in enumerate(proposal_nums):
                out[f'recall@{num}'] = float(rec[i, 0])
        else:
            raise KeyError(metric)
        return out
