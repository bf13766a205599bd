"""Sigmoid focal loss (counterpart of the JAX package's
`models/losses/focal_loss.py:sigmoid_focal_loss`). Heads emit logits and the
loss applies the sigmoid once."""

from __future__ import annotations

from typing import Optional

import torch

from .utils import one_hot, weight_reduce_loss


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
    bce = torch.clamp(logits, min=0) - logits * onehot + torch.log1p(
        torch.exp(-logits.abs()))
    loss = bce * focal_weight
    if weight is not None and weight.dim() == logits.dim() - 1:
        weight = weight[..., None]
    return weight_reduce_loss(loss, weight, reduction, avg_factor)
