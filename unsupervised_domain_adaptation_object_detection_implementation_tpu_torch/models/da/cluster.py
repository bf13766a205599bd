"""Masked, fixed-iteration cosine k-means for grouping instance features
(counterpart of the JAX package's `models/da/cluster.py`).

Static shapes: one (N, K) distance matrix per iteration, masked rows, and a
fixed-size representative set. Ties go as in the JAX package: the "valid
rows first" order is a stable sort, `argmin`/`argmax` pick the lowest index,
and a cluster that comes out empty keeps its old centroid.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _cosine_dist(a: torch.Tensor, b: torch.Tensor,
                 eps: float = 1e-8) -> torch.Tensor:
    """(N, D) x (K, D) → (N, K) cosine distances."""
    an = a / torch.clamp(torch.linalg.vector_norm(a, dim=-1, keepdim=True),
                         min=eps)
    bn = b / torch.clamp(torch.linalg.vector_norm(b, dim=-1, keepdim=True),
                         min=eps)
    return 1.0 - an @ bn.T


def _valid_first(mask: torch.Tensor) -> torch.Tensor:
    """Row order with the masked rows first, each group in index order."""
    return torch.sort((~mask).to(torch.int8), stable=True).indices


def masked_kmeans(feats: torch.Tensor, mask: torch.Tensor, k: int,
                  iters: int = 5) -> torch.Tensor:
    """Cosine k-means over the masked rows of (N, D); returns (K, D)
    centroids, initialised from the first k valid rows (wrapping when
    fewer)."""
    feats = feats.float()
    packed = feats[_valid_first(mask)]
    num_valid = mask.sum()
    init_idx = torch.arange(k, device=feats.device) % torch.clamp(num_valid,
                                                                  min=1)
    cents = packed[init_idx]
    maskf = mask.to(feats.dtype)[:, None]
    for _ in range(iters):
        assign = torch.argmin(_cosine_dist(feats, cents), dim=-1)
        onehot = (assign[:, None] == torch.arange(k, device=feats.device)
                  ).to(feats.dtype) * maskf                     # (N, K)
        counts = onehot.sum(dim=0)
        new = (onehot.T @ feats) / torch.clamp(counts[:, None], min=1.0)
        cents = torch.where(counts[:, None] > 0, new, cents)
    return cents


def group_representatives(feats: torch.Tensor, mask: torch.Tensor,
                          scores: torch.Tensor, k: int = 16,
                          kmeans_iters: int = 5
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-size (K, D) representatives of a masked bucket of (N, D):
    k-means centroids when more than k rows are valid; else the valid rows
    padded to k with the top-scoring valid row; all invalid when none is.
    Returns (reps (K, D), rep_valid (K,))."""
    feats = feats.float()
    n = feats.shape[0]
    num_valid = mask.sum()
    centroids = masked_kmeans(feats, mask, k, kmeans_iters)
    packed = feats[_valid_first(mask)]
    best_idx = torch.argmax(torch.where(mask, scores, float('-inf')))
    best = feats[best_idx]
    slot = torch.arange(k, device=feats.device)
    padded = torch.where((slot < num_valid)[:, None],
                         packed[slot.clamp(max=n - 1)], best[None, :])
    reps = torch.where(num_valid > k, centroids, padded)
    rep_valid = (num_valid > 0).expand(k)
    return reps, rep_valid
