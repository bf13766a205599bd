"""Domain-alignment losses (counterpart of the JAX package's
`models/da/losses.py`: `global_alignment_loss`, `patch_ls_loss` and
`grouped_instance_loss`).

Gradients flow through the GRL heads by default (`quirk_detach=False`);
`quirk_detach=True` reproduces the reference's detached numbers.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..losses import sigmoid_focal_loss, softmax_cross_entropy
from .cluster import group_representatives


def global_alignment_loss(logits: torch.Tensor, domain: torch.Tensor,
                          quirk_detach: bool = False) -> torch.Tensor:
    """CE between (B, 2) domain logits and the (B,) domain labels."""
    loss = softmax_cross_entropy(logits, domain).mean()
    return loss.detach() if quirk_detach else loss


def patch_ls_loss(logit_map: torch.Tensor, domain: torch.Tensor,
                  quirk_sigmoid_shift: bool = False) -> torch.Tensor:
    """Least-squares patch loss over (B, H, W, 1) logit maps, summed over
    the batch: source images 0.5·mean(σ(f)²), target 0.5·mean((1−σ(f))²)
    (0.5·mean(σ(1−f)²) with `quirk_sigmoid_shift`)."""
    p = torch.sigmoid(logit_map)
    per_img_src = 0.5 * (p**2).mean(dim=(1, 2, 3))
    if quirk_sigmoid_shift:
        per_img_tgt = 0.5 * (torch.sigmoid(1.0 - logit_map)**2).mean(
            dim=(1, 2, 3))
    else:
        per_img_tgt = 0.5 * ((1.0 - p)**2).mean(dim=(1, 2, 3))
    return torch.where(domain == 1, per_img_tgt, per_img_src).sum()


def grouped_instance_loss(
        fore_head_apply: Callable[[torch.Tensor], torch.Tensor],
        back_head_apply: Callable[[torch.Tensor], torch.Tensor],
        bbox_feats: torch.Tensor,
        cls_scores: torch.Tensor,
        valid: torch.Tensor,
        domain: torch.Tensor,
        k: int = 20,
        quirk_detach: bool = False) -> torch.Tensor:
    """Grouped fg/bg instance alignment: RoIs split by the softmax
    background probability of the (C+1)-column class scores (fg when it is
    below 0.5), grouped per (domain, fg/bg) bucket into k representatives,
    classified by the fore/back heads with a focal loss.

    Args:
        bbox_feats: (B, S, D) shared-FC features; cls_scores (B, S, C+1);
        valid: (B, S) sampled-RoI validity; domain: (B,).
    """
    b, s, d = bbox_feats.shape
    feats = bbox_feats.reshape(-1, d)
    probs = torch.softmax(cls_scores.float(), dim=-1).reshape(b * s, -1)
    fg_score = 1.0 - probs[:, -1]
    is_fg = fg_score >= 0.5
    v = valid.reshape(-1)
    dom = domain.repeat_interleave(s)

    def bucket(domain_val, fg):
        mask = v & (dom == domain_val) & (is_fg == fg)
        score = fg_score if fg else 1.0 - fg_score
        return group_representatives(feats, mask, score, k)

    total = 0.0
    for fg, head in ((True, fore_head_apply), (False, back_head_apply)):
        src_reps, src_valid = bucket(0, fg)
        tgt_reps, tgt_valid = bucket(1, fg)
        reps = torch.cat([src_reps, tgt_reps], dim=0)             # (2K, D)
        labels = torch.cat([torch.zeros(k, dtype=torch.long),
                            torch.ones(k, dtype=torch.long)]).to(reps.device)
        rep_valid = torch.cat([src_valid, tgt_valid])
        logits = head(reps)                                       # (2K, 2)
        loss = sigmoid_focal_loss(logits, labels,
                                  weight=rep_valid.to(logits.dtype),
                                  reduction='sum')
        # reference-numerics mode: mmdet's mean over N·C elements (C = 2)
        denom = rep_valid.sum() * (2.0 if quirk_detach else 1.0)
        total = total + loss / torch.clamp(denom, min=1.0)
    return total.detach() if quirk_detach else total
