"""Generalized Focal Loss (counterpart of the JAX package's
`models/losses/gfocal_loss.py`): the quality focal loss over soft IoU
targets and the distribution focal loss over a side's bins, with their
loss classes. The varifocal loss is not ported yet."""

from __future__ import annotations

from typing import Optional

import torch

from ...utils.registry import LOSSES
from .utils import jax_abs, jax_max, one_hot, weight_reduce_loss


def quality_focal_loss(logits: torch.Tensor,
                       labels: torch.Tensor,
                       quality: torch.Tensor,
                       weight: Optional[torch.Tensor] = None,
                       beta: float = 2.0,
                       reduction: str = 'mean',
                       avg_factor=None) -> torch.Tensor:
    """QFL over (..., C) logits: the target is `quality` (...,) on the
    label's class (label C, the background, gives all zeros), each term
    scaled by |target - sigmoid|^beta. The gradient flows through
    `quality` too, as in the JAX package."""
    logits = logits.float()
    soft = one_hot(labels, logits.shape[-1], logits.dtype) * quality[..., None]
    p = torch.sigmoid(logits)
    scale = jax_abs(soft - p) ** beta
    bce = jax_max(logits, 0) - logits * soft + torch.log1p(
        torch.exp(-jax_abs(logits)))
    if weight is not None and weight.dim() == logits.dim() - 1:
        weight = weight[..., None]
    return weight_reduce_loss(bce * scale, weight, reduction, avg_factor)


def distribution_focal_loss(logits: torch.Tensor,
                            target: torch.Tensor,
                            weight: Optional[torch.Tensor] = None,
                            reduction: str = 'mean',
                            avg_factor=None) -> torch.Tensor:
    """DFL over (..., n) bin logits: the cross-entropy of the two bins
    around the continuous `target` (...,) (clipped to [0, n - 1 - 1e-4]),
    weighted by its distance to each."""
    logits = logits.float()
    n = logits.shape[-1]
    t = target.clamp(0, n - 1 - 1e-4)
    lo = torch.floor(t).long()
    w_hi = t - lo
    w_lo = 1.0 - w_hi
    logp = torch.log_softmax(logits, dim=-1)

    def pick(idx):
        return torch.gather(logp, -1, idx[..., None])[..., 0]

    loss = -(pick(lo) * w_lo + pick((lo + 1).clamp(max=n - 1)) * w_hi)
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


@LOSSES.register_module()
class QualityFocalLoss:
    def __init__(self, beta=2.0, reduction='mean', loss_weight=1.0):
        self.beta = beta
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        labels, quality = target
        return self.loss_weight * quality_focal_loss(
            pred, labels, quality, weight, self.beta,
            reduction_override or self.reduction, avg_factor)


@LOSSES.register_module()
class DistributionFocalLoss:
    def __init__(self, reduction='mean', loss_weight=1.0):
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        return self.loss_weight * distribution_focal_loss(
            pred, target, weight, reduction_override or self.reduction,
            avg_factor)
