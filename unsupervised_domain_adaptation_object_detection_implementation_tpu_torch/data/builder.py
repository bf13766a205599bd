"""Datasets, batch collation and the loader (counterpart of the JAX
package's `data/builder.py`).

`build_dataset(cfg, device)` builds a registered dataset whose samples are
made on `device` (CUDA unless the caller asks for the CPU); `DataLoader` walks its batch sampler (the two-stream one
for a `ConcatDataset` of a source and a target dataset) and yields batch
dicts of tensors on that device, made ahead by one background thread with a
queue of `prefetch` batches.
"""

from __future__ import annotations

import queue
import threading
from typing import (Callable, Dict, Iterator, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.registry import DATASETS
from .samplers.two_stream import GroupBatchSampler, TwoStreamBatchSampler


def build_dataset(cfg, device: Union[str, torch.device] = 'cuda'):
    """The registered dataset of `cfg` (a dict with `type`), its samples
    made on `device` (CUDA unless the caller asks for the CPU; raises
    without a card); wrappers build their sub-datasets there too."""
    return DATASETS.build(dict(cfg), device=resolve_device(device))


def collate(samples: Sequence[dict]) -> Dict[str, torch.Tensor]:
    """Stack a list of `PackDetInputs` outputs into a batch dict of tensors,
    all on the device of the samples' `image`."""
    device = samples[0]['image'].device
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], torch.Tensor):
            out[k] = torch.stack(vals)
        else:
            out[k] = torch.as_tensor(np.stack(vals), device=device)
    return out


class _Prefetcher:
    """Runs `gen_fn()` in a daemon thread, `depth` items ahead of the
    consumer. An exception in the thread is raised to the consumer; a
    consumer that stops early (or is closed) stops the thread."""

    def __init__(self, gen_fn: Callable[[], Iterator], depth: int = 2):
        self.gen_fn = gen_fn
        self.depth = depth

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        done = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in self.gen_fn():
                    if not put((None, item)):
                        return
            except Exception as e:      # handed to the consumer
                put((e, None))
                return
            put((None, done))

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                err, item = q.get()
                if err is not None:
                    raise err
                if item is done:
                    break
                yield item
        finally:
            stop.set()
            t.join(timeout=10)


class DataLoader:
    """Epoch-iterable loader of batch dicts.

    A `ConcatDataset` of two datasets of different domains gets the
    two-stream sampler (`two_stream=None` detects it), anything else the
    shuffled `GroupBatchSampler`. `len()` is the number of batches an
    epoch. Samples are made in the sampler's order, so the datasets' random
    draws follow the JAX package's. `prefetch=0` makes each batch when it is
    asked for. `rows=(lo, hi)` yields rows lo:hi of each batch (a rank's
    rows of the global batch under data parallelism): every sample of the
    batch is still made, in order, so that the datasets' draws, and so
    these rows, equal those of one process's batch, as each JAX host walks
    the global sampler and keeps its rows."""

    def __init__(self,
                 dataset,
                 samples_per_batch: int,
                 shuffle: bool = True,
                 seed: int = 0,
                 two_stream: Optional[bool] = None,
                 steps_per_epoch: Optional[int] = None,
                 prefetch: int = 2,
                 drop_last: bool = True,
                 rows: Optional[Tuple[int, int]] = None):
        from .datasets.wrappers import ConcatDataset
        self.dataset = dataset
        self.samples_per_batch = samples_per_batch
        if two_stream is None:
            two_stream = isinstance(dataset, ConcatDataset) and \
                len(dataset.datasets) == 2 and \
                getattr(dataset.datasets[0], 'domain', 0) != \
                getattr(dataset.datasets[1], 'domain', 0)
        self.two_stream = two_stream
        if two_stream:
            self.sampler = TwoStreamBatchSampler(
                len(dataset.datasets[0]), len(dataset.datasets[1]),
                samples_per_batch, seed, steps_per_epoch)
        else:
            self.sampler = GroupBatchSampler(
                len(dataset), samples_per_batch, shuffle, seed, drop_last)
        self.prefetch = prefetch
        self.rows = rows

    def __len__(self):
        return len(self.sampler)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        lo, hi = self.rows or (None, None)

        def gen():
            for batch_idx in self.sampler:
                yield collate([self.dataset[i] for i in batch_idx][lo:hi])

        if self.prefetch:
            return iter(_Prefetcher(gen, self.prefetch))
        return gen()


def _rng_state(rng: np.random.RandomState) -> list:
    name, keys, pos, has_gauss, gauss = rng.get_state()
    return [name, keys.tolist(), int(pos), int(has_gauss), float(gauss)]


def _set_rng_state(rng: np.random.RandomState, state: list):
    name, keys, pos, has_gauss, gauss = state
    rng.set_state((name, np.asarray(keys, np.uint32), pos, has_gauss, gauss))


def _drawing_datasets(dataset) -> list:
    """The datasets under `dataset` (itself, a `ConcatDataset`'s parts, a
    `RepeatDataset`'s inner one) that draw from a `RandomState` of their
    own, in order."""
    if hasattr(dataset, 'datasets'):
        return [d for sub in dataset.datasets
                for d in _drawing_datasets(sub)]
    if hasattr(dataset, 'dataset'):
        return _drawing_datasets(dataset.dataset)
    return [dataset] if hasattr(dataset, '_rng') else []


def loader_state(loader: 'DataLoader') -> dict:
    """The loader's random state between two epochs, as JSON: its
    sampler's `RandomState` (and the two-stream sampler's pools) and each
    dataset's. Taken when an epoch's batches are all made (the prefetch
    thread stops at the epoch's end), it makes a resumed run draw the
    batches an uninterrupted one draws."""
    sampler = loader.sampler
    return dict(sampler=_rng_state(sampler.rng),
                pools=[list(getattr(sampler, '_src_pool', [])),
                       list(getattr(sampler, '_tgt_pool', []))],
                datasets=[_rng_state(d._rng)
                          for d in _drawing_datasets(loader.dataset)])


def load_loader_state(loader: 'DataLoader', state: dict):
    """Restore a `loader_state`."""
    sampler = loader.sampler
    _set_rng_state(sampler.rng, state['sampler'])
    if hasattr(sampler, '_src_pool'):
        sampler._src_pool[:], sampler._tgt_pool[:] = state['pools']
    datasets = _drawing_datasets(loader.dataset)
    if len(datasets) != len(state['datasets']):
        raise ValueError(f'the loader state holds {len(state["datasets"])} '
                         f'datasets, this loader {len(datasets)}')
    for d, s in zip(datasets, state['datasets']):
        _set_rng_state(d._rng, s)


def build_dataloader(dataset, samples_per_gpu: int, shuffle: bool = True,
                     seed: int = 0, **kwargs) -> DataLoader:
    """One device's loader: `samples_per_gpu` rows a batch."""
    return DataLoader(dataset, samples_per_gpu, shuffle, seed, **kwargs)
