"""Smooth-L1 loss (counterpart of the JAX package's
`models/losses/smooth_l1_loss.py:smooth_l1_loss`)."""

from __future__ import annotations

from typing import Optional

import torch

from .utils import weight_reduce_loss


def smooth_l1_loss(pred: torch.Tensor,
                   target: torch.Tensor,
                   weight: Optional[torch.Tensor] = None,
                   beta: float = 1.0,
                   reduction: str = 'mean',
                   avg_factor=None) -> torch.Tensor:
    diff = (pred.float() - target.float()).abs()
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)
    return weight_reduce_loss(loss, weight, reduction, avg_factor)
