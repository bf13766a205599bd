"""Domain-alignment losses (counterpart of the JAX package's
`models/da/losses.py`: `global_alignment_loss`, `patch_ls_loss`,
`image_da_loss`, `consistency_loss` and `grouped_instance_loss`).

Gradients flow through the GRL heads by default (`quirk_detach=False`);
`quirk_detach=True` reproduces the reference's detached numbers.

Under data parallelism each is the rank's share of the loss of the global
batch (`parallel/batch.py`): means and normalizers over the global batch,
and the grouped instance loss's k-means over its RoIs.
"""

from __future__ import annotations

from typing import Callable

import torch

from ...parallel.batch import (all_reduce_sum, batch_mean, batch_total,
                               data_parallel, gather_rows, replica_share,
                               replicated)
from ..losses import sigmoid_focal_loss, softmax_cross_entropy
from .cluster import group_representatives


def global_alignment_loss(logits: torch.Tensor, domain: torch.Tensor,
                          quirk_detach: bool = False) -> torch.Tensor:
    """CE between (B, 2) domain logits and the (B,) domain labels."""
    loss = batch_mean(softmax_cross_entropy(logits, domain))
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


def image_da_loss(logit_map: torch.Tensor,
                  domain: torch.Tensor) -> torch.Tensor:
    """DAF-original image-level loss on the (B, H, W, 1) image head map:
    the least-squares patch form, without the sigmoid-shift quirk."""
    return patch_ls_loss(logit_map, domain)


def consistency_loss(img_logit_map: torch.Tensor, ins_logits: torch.Tensor,
                     ins_valid: torch.Tensor,
                     domain: torch.Tensor) -> torch.Tensor:
    """DAF's image/instance consistency regulariser: the root of the mean,
    over valid RoIs, of (mean σ of the image map − σ of the RoI's target
    logit)². `img_logit_map` (B, H, W, 1), `ins_logits` (B, S, 2),
    `ins_valid` (B, S); `domain` is unused, as in the JAX function."""
    img_prob = torch.sigmoid(img_logit_map).mean(dim=(1, 2, 3))     # (B,)
    ins_prob = torch.sigmoid(ins_logits[..., 1])                     # (B, S)
    v = ins_valid.to(ins_prob.dtype)
    diff = (img_prob[:, None] - ins_prob) ** 2 * v
    return replica_share(torch.sqrt(all_reduce_sum(diff.sum()) / torch.clamp(
        batch_total(v.sum()), min=1.0)))


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

    Under data parallelism every rank groups the RoIs of the global batch
    (`gather_rows`) and returns its share of the term.
    """
    if data_parallel():
        args = (fore_head_apply, back_head_apply, gather_rows(bbox_feats),
                gather_rows(cls_scores.detach()), gather_rows(valid),
                gather_rows(domain), k, quirk_detach)
        with replicated():
            total = grouped_instance_loss(*args)
        return replica_share(total)
    b, s, d = bbox_feats.shape
    feats = bbox_feats.reshape(-1, d)
    probs = torch.softmax(cls_scores, dim=-1).reshape(b * s, -1)
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
