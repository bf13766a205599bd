"""Sigmoid focal loss (counterpart of the JAX package's
`models/losses/focal_loss.py:sigmoid_focal_loss`). Heads emit logits and the
loss applies the sigmoid once. At a logit of exactly 0 the gradient is
JAX's (`jnp.maximum`'s one half, `jnp.abs`'s +1)."""

from __future__ import annotations

from typing import Optional

import torch

from .utils import jax_abs, jax_max, one_hot, weight_reduce_loss


def sigmoid_focal_loss(logits: torch.Tensor,
                       labels: torch.Tensor,
                       weight: Optional[torch.Tensor] = None,
                       gamma: float = 2.0,
                       alpha: float = 0.25,
                       reduction: str = 'mean',
                       avg_factor=None) -> torch.Tensor:
    """Focal loss over (..., C) logits and integer labels (...,); label C
    means background (all-zero targets)."""
    logits = logits.float()
    num_classes = logits.shape[-1]
    onehot = one_hot(labels, num_classes, logits.dtype)
    p = torch.sigmoid(logits)
    pt = (1 - p) * onehot + p * (1 - onehot)
    focal_weight = (alpha * onehot + (1 - alpha) * (1 - onehot)) * pt**gamma
    bce = jax_max(logits, 0) - logits * onehot + torch.log1p(
        torch.exp(-jax_abs(logits)))
    loss = bce * focal_weight
    if weight is not None and weight.dim() == logits.dim() - 1:
        weight = weight[..., None]
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def ghm_edges(bins: int = 10) -> torch.Tensor:
    """The histogram's static edges, linspace(0, 1 + 1e-6, bins + 1) in
    float32, as `jnp.linspace` computes them: start + i · step, then the
    last edge set to the stop."""
    stop = torch.tensor(1.0 + 1e-6, dtype=torch.float32)
    step = stop / bins
    edges = torch.arange(bins + 1, dtype=torch.float32) * step
    edges[-1] = stop
    return edges


def ghm_classification_loss(logits: torch.Tensor,
                            labels: torch.Tensor,
                            valid: torch.Tensor,
                            bins: int = 10) -> torch.Tensor:
    """GHM-C (counterpart of the JAX package's
    `models/losses/focal_loss.py:ghm_classification_loss`): sigmoid BCE
    over (..., N, C) logits, each term weighted by total / (count of its
    bin · bins), the bins a static `bins`-bin histogram of the gradient
    norm |sigmoid - target| over the valid (..., N) anchors' terms of one
    image, then over the total. Returns one loss per leading index (the
    JAX function is vmapped over images); the weights carry no gradient."""
    logits = logits.float()
    onehot = one_hot(labels, logits.shape[-1], logits.dtype)
    g = (torch.sigmoid(logits) - onehot).abs()
    v = valid[..., None].to(logits.dtype).expand_as(g)
    edges = ghm_edges(bins).to(logits.device)
    total = v.sum((-2, -1)).clamp(min=1.0)[..., None, None]
    weights = torch.zeros_like(g)
    live = v > 0
    for i in range(bins):
        in_bin = (g >= edges[i]) & (g < edges[i + 1]) & live
        cnt = in_bin.sum((-2, -1)).to(logits.dtype).clamp(
            min=1.0)[..., None, None]
        weights = torch.where(in_bin, total / (cnt * bins), weights)
    bce = jax_max(logits, 0) - logits * onehot + torch.log1p(
        torch.exp(-jax_abs(logits)))
    return (bce * weights * v).sum((-2, -1)) / total[..., 0, 0]
