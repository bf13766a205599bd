"""IoU-family box losses (counterpart of the JAX package's
`models/losses/iou_loss.py`): IoU (log or linear), GIoU, DIoU, CIoU and
bounded IoU over aligned (..., 4) xyxy boxes, and the loss classes. Every
`jnp.maximum` / `jnp.minimum` / `jnp.abs` of the JAX package keeps its
gradient at a tie (one half) or at 0 (+1): `jax_max`, `torch.minimum`,
`jax_abs`."""

from __future__ import annotations

import math

import torch

from ...utils.registry import LOSSES
from .utils import jax_abs, jax_max, weight_reduce_loss


def _aligned_iou_terms(pred: torch.Tensor, target: torch.Tensor,
                       eps: float = 1e-6):
    """(iou, union, enclosing wh, enclosing lt, enclosing rb)."""
    lt = torch.maximum(pred[..., :2], target[..., :2])
    rb = torch.minimum(pred[..., 2:], target[..., 2:])
    wh = jax_max(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    ap = jax_max(pred[..., 2] - pred[..., 0], 0) * \
        jax_max(pred[..., 3] - pred[..., 1], 0)
    at = jax_max(target[..., 2] - target[..., 0], 0) * \
        jax_max(target[..., 3] - target[..., 1], 0)
    union = jax_max(ap + at - inter, eps)
    iou = inter / union
    elt = torch.minimum(pred[..., :2], target[..., :2])
    erb = torch.maximum(pred[..., 2:], target[..., 2:])
    ewh = jax_max(erb - elt, 0.0)
    return iou, union, ewh, elt, erb


def iou_loss(pred, target, weight=None, eps=1e-6, reduction='mean',
             avg_factor=None, linear=False):
    """-log(IoU) (IoU clamped to `eps`), or 1 - IoU with `linear`."""
    iou = _aligned_iou_terms(pred, target, eps)[0]
    loss = 1 - iou if linear else -torch.log(jax_max(iou, eps))
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def giou_loss(pred, target, weight=None, eps=1e-6, reduction='mean',
              avg_factor=None):
    iou, union, ewh, _, _ = _aligned_iou_terms(pred, target, eps)
    enclose = jax_max(ewh[..., 0] * ewh[..., 1], eps)
    giou = iou - (enclose - union) / enclose
    return weight_reduce_loss(1 - giou, weight, reduction, avg_factor)


def _center_distance(pred, target, ewh, eps):
    """(squared center distance, squared enclosing diagonal + eps)."""
    c2 = ewh[..., 0]**2 + ewh[..., 1]**2 + eps
    pc = (pred[..., :2] + pred[..., 2:]) * 0.5
    tc = (target[..., :2] + target[..., 2:]) * 0.5
    return ((pc - tc)**2).sum(-1), c2


def diou_loss(pred, target, weight=None, eps=1e-6, reduction='mean',
              avg_factor=None):
    iou, _, ewh, _, _ = _aligned_iou_terms(pred, target, eps)
    rho2, c2 = _center_distance(pred, target, ewh, eps)
    return weight_reduce_loss(1 - (iou - rho2 / c2), weight, reduction,
                              avg_factor)


def ciou_loss(pred, target, weight=None, eps=1e-6, reduction='mean',
              avg_factor=None):
    iou, _, ewh, _, _ = _aligned_iou_terms(pred, target, eps)
    rho2, c2 = _center_distance(pred, target, ewh, eps)
    pw = jax_max(pred[..., 2] - pred[..., 0], eps)
    ph = jax_max(pred[..., 3] - pred[..., 1], eps)
    tw = jax_max(target[..., 2] - target[..., 0], eps)
    th = jax_max(target[..., 3] - target[..., 1], eps)
    v = (4 / math.pi**2) * (torch.atan(tw / th) - torch.atan(pw / ph))**2
    alpha = v / jax_max(1 - iou + v, eps)
    return weight_reduce_loss(1 - (iou - rho2 / c2 - alpha * v), weight,
                              reduction, avg_factor)


def bounded_iou_loss(pred, target, weight=None, beta=0.2, eps=1e-3,
                     reduction='mean', avg_factor=None):
    """Bounded IoU (IoU-Net): per-coordinate bounded overlap terms, smooth-L1
    composed with `beta`; the target's width and height get no gradient."""
    px = (pred[..., 0] + pred[..., 2]) * 0.5
    py = (pred[..., 1] + pred[..., 3]) * 0.5
    pw = pred[..., 2] - pred[..., 0]
    ph = pred[..., 3] - pred[..., 1]
    tx = (target[..., 0] + target[..., 2]) * 0.5
    ty = (target[..., 1] + target[..., 3]) * 0.5
    tw = (target[..., 2] - target[..., 0]).detach()
    th = (target[..., 3] - target[..., 1]).detach()
    # a box centered on its target still pulls the bounded overlap (the
    # eps keeps it under 1) through |d|'s gradient at 0
    dx = jax_abs(tx - px)
    dy = jax_abs(ty - py)
    loss_dx = 1 - jax_max((tw - 2 * dx) / (tw + 2 * dx + eps), 0)
    loss_dy = 1 - jax_max((th - 2 * dy) / (th + 2 * dy + eps), 0)
    loss_dw = 1 - torch.minimum(tw / (pw + eps), pw / (tw + eps))
    loss_dh = 1 - torch.minimum(th / (ph + eps), ph / (th + eps))
    comb = torch.stack([loss_dx, loss_dy, loss_dw, loss_dh], dim=-1)
    loss = torch.where(comb < beta, 0.5 * comb * comb / beta,
                       comb - 0.5 * beta).sum(-1)
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


class _IoUFamilyLoss:
    """`loss_weight` x the subclass's `_loss`, `reduction` overridable per
    call."""

    def __init__(self, eps=1e-6, reduction='mean', loss_weight=1.0):
        self.eps = eps
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        reduction = reduction_override or self.reduction
        return self.loss_weight * self._loss(pred, target, weight, reduction,
                                             avg_factor)


@LOSSES.register_module()
class IoULoss(_IoUFamilyLoss):
    def __init__(self, linear=False, eps=1e-6, reduction='mean',
                 loss_weight=1.0):
        super().__init__(eps, reduction, loss_weight)
        self.linear = linear

    def _loss(self, pred, target, weight, reduction, avg_factor):
        return iou_loss(pred, target, weight, self.eps, reduction,
                        avg_factor, self.linear)


@LOSSES.register_module()
class GIoULoss(_IoUFamilyLoss):
    def _loss(self, pred, target, weight, reduction, avg_factor):
        return giou_loss(pred, target, weight, self.eps, reduction,
                         avg_factor)


@LOSSES.register_module()
class BoundedIoULoss(_IoUFamilyLoss):
    def __init__(self, beta=0.2, eps=1e-3, reduction='mean',
                 loss_weight=1.0):
        super().__init__(eps, reduction, loss_weight)
        self.beta = beta

    def _loss(self, pred, target, weight, reduction, avg_factor):
        return bounded_iou_loss(pred, target, weight, self.beta, self.eps,
                                reduction, avg_factor)
