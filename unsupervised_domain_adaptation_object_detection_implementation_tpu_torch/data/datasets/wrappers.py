"""Dataset wrappers (counterpart of `ConcatDataset` and `RepeatDataset` in
the JAX package's `data/datasets/wrappers.py`; `ClassBalancedDataset` and
`MultiImageMixDataset` are not ported)."""

from __future__ import annotations

import bisect
from typing import List, Union

import numpy as np
import torch

from ...utils.registry import DATASETS


@DATASETS.register_module()
class ConcatDataset:
    """Datasets end to end, keeping their boundaries: the DA train set is
    `ConcatDataset([source, target])`. Sub-dataset configs are built on
    `device` (CUDA unless the caller asks for the CPU)."""

    def __init__(self, datasets: List,
                 device: Union[str, torch.device] = 'cuda'):
        from ..builder import build_dataset
        self.datasets = [
            d if not isinstance(d, dict) else build_dataset(d, device)
            for d in datasets
        ]
        self.cumulative_sizes = np.cumsum(
            [len(d) for d in self.datasets]).tolist()
        self.CLASSES = self.datasets[0].CLASSES

    def __len__(self):
        return self.cumulative_sizes[-1]

    def _locate(self, idx: int):
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        base = 0 if ds_idx == 0 else self.cumulative_sizes[ds_idx - 1]
        return ds_idx, idx - base

    def __getitem__(self, idx: int):
        ds_idx, local = self._locate(idx)
        return self.datasets[ds_idx][local]

    def get_ann_info(self, idx: int):
        ds_idx, local = self._locate(idx)
        return self.datasets[ds_idx].get_ann_info(local)


@DATASETS.register_module()
class RepeatDataset:
    """A dataset `times` over end to end: an epoch of the `mstrain-poly_3x`
    configs. A sub-dataset config is built on `device` (CUDA unless the
    caller asks for the CPU)."""

    def __init__(self, dataset, times: int,
                 device: Union[str, torch.device] = 'cuda'):
        from ..builder import build_dataset
        self.dataset = dataset if not isinstance(dataset, dict) else \
            build_dataset(dataset, device)
        self.times = times
        self.CLASSES = self.dataset.CLASSES

    def __len__(self):
        return self.times * len(self.dataset)

    def __getitem__(self, idx: int):
        return self.dataset[idx % len(self.dataset)]

    def get_ann_info(self, idx: int):
        return self.dataset.get_ann_info(idx % len(self.dataset))
