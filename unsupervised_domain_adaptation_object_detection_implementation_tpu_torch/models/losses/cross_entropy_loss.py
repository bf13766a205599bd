"""Cross-entropy losses (counterpart of the JAX package's
`models/losses/cross_entropy_loss.py`).

`cross_entropy` is softmax CE over integer labels; `binary_cross_entropy`
is the `use_sigmoid=True` path, where integer labels are one-hot expanded
(label == C, the background, gives the all-zero row).
"""

from __future__ import annotations

from typing import Optional

import torch

from .utils import one_hot, weight_reduce_loss


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Per-sample softmax CE with integer labels: (..., C) x (...,) →
    (...,), in f32; labels outside [0, C) are clipped into it."""
    logits = logits.float()
    log_probs = torch.log_softmax(logits, dim=-1)
    labels = labels.long().clamp(0, logits.shape[-1] - 1)
    return -torch.gather(log_probs, -1, labels[..., None])[..., 0]


def cross_entropy(logits: torch.Tensor,
                  labels: torch.Tensor,
                  weight: Optional[torch.Tensor] = None,
                  reduction: str = 'mean',
                  avg_factor=None,
                  class_weight: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    loss = softmax_cross_entropy(logits, labels)
    if class_weight is not None:
        loss = loss * class_weight[labels.long()]
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def binary_cross_entropy(logits: torch.Tensor,
                         labels: torch.Tensor,
                         weight: Optional[torch.Tensor] = None,
                         reduction: str = 'mean',
                         avg_factor=None) -> torch.Tensor:
    """BCE with logits. Integer `labels` of shape (...) are one-hot expanded
    to the (..., C) logits (label C maps to the all-zero row); float labels
    of the logits' shape are used as they are."""
    logits = logits.float()
    if labels.dim() == logits.dim() - 1:
        num_classes = logits.shape[-1]
        labels = one_hot(labels, num_classes, logits.dtype)
        if weight is not None and weight.dim() == logits.dim() - 1:
            weight = weight[..., None]
    labels = labels.to(logits.dtype)
    loss = torch.clamp(logits, min=0) - logits * labels + torch.log1p(
        torch.exp(-logits.abs()))
    return weight_reduce_loss(loss, weight, reduction, avg_factor)
