"""Batch index samplers (counterpart of the JAX package's
`data/samplers/two_stream.py`), drawing from `np.random.RandomState(seed)`
in the same order, so both packages give the same indices.

`TwoStreamBatchSampler` interleaves source and target, [s, t, s, t, ...];
each stream draws from a reshuffled permutation of its dataset whenever its
pool runs dry, so the shorter stream recycles. `GroupBatchSampler` is a
plain shuffled batch sampler (every padded image has the canvas' shape, so
no aspect-ratio grouping is needed).
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np


class TwoStreamBatchSampler:
    def __init__(self, source_size: int, target_size: int,
                 samples_per_batch: int, seed: int = 0,
                 steps_per_epoch: Optional[int] = None):
        if samples_per_batch % 2:
            raise ValueError('two-stream batches need an even batch size, '
                             f'got {samples_per_batch}')
        self.source_size = source_size
        self.target_size = target_size
        self.per_stream = samples_per_batch // 2
        self.rng = np.random.RandomState(seed)
        if steps_per_epoch is None:
            steps_per_epoch = (source_size + target_size) // samples_per_batch
        self.steps_per_epoch = max(steps_per_epoch, 1)
        self._src_pool: List[int] = []
        self._tgt_pool: List[int] = []

    def _draw(self, pool: List[int], size: int, n: int) -> List[int]:
        out = []
        while len(out) < n:
            if not pool:
                pool.extend(self.rng.permutation(size).tolist())
            out.append(pool.pop())
        return out

    def __iter__(self) -> Iterator[List[int]]:
        """Batches of indices into ConcatDataset([source, target]): source
        in [0, source_size), target offset by source_size."""
        for _ in range(self.steps_per_epoch):
            src = self._draw(self._src_pool, self.source_size,
                             self.per_stream)
            tgt = self._draw(self._tgt_pool, self.target_size,
                             self.per_stream)
            batch = []
            for s, t in zip(src, tgt):
                batch.append(s)
                batch.append(self.source_size + t)
            yield batch

    def __len__(self):
        return self.steps_per_epoch


class GroupBatchSampler:
    """Shuffled (or in-order) batches; without `drop_last` the last batch
    is filled up from the start of the order."""

    def __init__(self, dataset_size: int, samples_per_batch: int,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True):
        self.dataset_size = dataset_size
        self.samples_per_batch = samples_per_batch
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.drop_last = drop_last

    def __iter__(self) -> Iterator[List[int]]:
        idx = np.arange(self.dataset_size)
        if self.shuffle:
            self.rng.shuffle(idx)
        n_full = self.dataset_size // self.samples_per_batch
        for b in range(n_full):
            yield idx[b * self.samples_per_batch:(b + 1) *
                      self.samples_per_batch].tolist()
        rem = self.dataset_size % self.samples_per_batch
        if rem and not self.drop_last:
            tail = idx[-rem:].tolist()
            tail += idx[:self.samples_per_batch - rem].tolist()
            yield tail

    def __len__(self):
        n_full = self.dataset_size // self.samples_per_batch
        if not self.drop_last and self.dataset_size % self.samples_per_batch:
            return n_full + 1
        return n_full
