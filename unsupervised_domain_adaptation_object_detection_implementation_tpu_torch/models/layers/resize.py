"""`jax.image.resize(..., 'nearest')` in torch, shared by the heads that
resize with it (HTC's semantic targets and mask flow, Grid R-CNN's
upsampling, Mask Scoring R-CNN's mask downsampling)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _nearest_index(m: int, n: int) -> np.ndarray:
    """The source index of each of n outputs resized from m: floor((i +
    0.5) · m / n) in float32, product first, as `jax.image.resize(...,
    'nearest')` computes it (torch's 'nearest-exact' multiplies by m / n
    instead, which can round across a whole number)."""
    pos = (np.arange(n, dtype=np.float32) + np.float32(0.5)) * np.float32(m)
    return np.floor(pos / np.float32(n)).astype(np.int64)


def resize_nearest(x: torch.Tensor, size: Tuple[int, int],
                   dims: Tuple[int, int] = (-2, -1)) -> torch.Tensor:
    """`jax.image.resize(x, ..., 'nearest')` over the two `dims` of x to
    `size`: half-pixel nearest with JAX's float32 source positions, as a
    gather (any dtype)."""
    for d, n in zip(dims, size):
        m = x.shape[d]
        if m != n:
            idx = torch.from_numpy(_nearest_index(m, n)).to(x.device)
            x = x.index_select(d, idx)
    return x
