"""PISA's re-weighting pair (counterpart of the JAX package's
`models/losses/extra_losses.py`: `isr_p_weights`, `carl_weights`;
reference `mmdet/models/losses/pisa_loss.py`).

Both take (..., P) rows, each leading index one image, and renormalize
within the image (so several ranks need no global form of them). The
weights are constants of the step where the callers pass detached
scores, as the JAX package's callers do.
"""

from __future__ import annotations

import torch


def isr_p_weights(pos_scores: torch.Tensor,
                  pos_ious: torch.Tensor,
                  pos_labels: torch.Tensor,
                  pos_valid: torch.Tensor,
                  num_classes: int,
                  k: float = 2.0,
                  bias: float = 0.0) -> torch.Tensor:
    """ISR-P: each positive's weight from its IoU-hierarchical local rank
    within its class, `bias + (1 - bias) · ((n - r) / n)^k` for rank r of
    the class's n positives, renormalized so the image's positive weights
    sum to its positive count; 1 where `pos_valid` is False. `pos_scores`
    gives only the shape, as in the JAX package.

    The ranks come from one stable sort of the f32 key `label · 2 + iou`
    (descending, invalid rows last), as `jnp.argsort` gives them, so that
    equal keys keep their order; each class's first rank is a scatter
    `amin` and its count a scatter add over the (image, class) cells."""
    del pos_scores
    lead, p = pos_ious.shape[:-1], pos_ious.shape[-1]
    key = torch.where(pos_valid, pos_labels.float() * 2.0 + pos_ious,
                      pos_ious.new_tensor(float('-inf')))
    order = torch.argsort(-key, dim=-1, stable=True)
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(p, device=order.device).expand_as(order))
    cls = torch.where(pos_valid, pos_labels.long(),
                      torch.full_like(pos_labels.long(), num_classes))
    cells = num_classes + 1
    rows = torch.arange(cls.numel() // max(p, 1), device=cls.device)
    flat = (cls.reshape(-1, p) + rows[:, None] * cells).reshape(-1)
    first = torch.full((rows.numel() * cells,), torch.iinfo(torch.int32).max,
                       dtype=torch.long, device=cls.device).scatter_reduce(
        0, flat, rank.reshape(-1), 'amin', include_self=True)
    n_cls = torch.zeros((rows.numel() * cells,), dtype=torch.float32,
                        device=cls.device).index_add(
        0, flat, pos_valid.reshape(-1).float())
    local_rank = (rank.reshape(-1) - first[flat]).reshape(*lead, p)
    n = n_cls[flat].reshape(*lead, p).clamp(min=1.0)
    w = bias + (1 - bias) * ((n - local_rank) / n) ** k
    total = torch.where(pos_valid, w, w.new_zeros(())).sum(
        -1, keepdim=True).clamp(min=1e-6)
    cnt = pos_valid.sum(-1, keepdim=True)
    w = w * cnt / total
    return torch.where(pos_valid, w, w.new_ones(()))


def carl_weights(pos_cls_scores: torch.Tensor,
                 pos_valid: torch.Tensor,
                 k: float = 1.0,
                 bias: float = 0.2) -> torch.Tensor:
    """CARL: the positives' regression weights `(bias + (1 - bias) · s)^k`
    for their own-class score s, normalized to mean 1 over each image's
    positives; 0 elsewhere."""
    w = (bias + (1 - bias) * pos_cls_scores) ** k
    denom = torch.where(pos_valid, w, w.new_zeros(())).sum(
        -1, keepdim=True).clamp(min=1e-6)
    cnt = pos_valid.sum(-1, keepdim=True).float().clamp(min=1.0)
    return torch.where(pos_valid, w * cnt / denom, w.new_zeros(()))
