"""PAA (counterpart of the JAX package's `models/detectors/paa.py`):
probabilistic anchor assignment on the ATSS head and anchors.

Per gt, the anchors whose centre lies inside it (edges included) are
scored by their joint loss -log p(gt class) - log IoU (from detached
predictions); the `topk_per_level` lowest of each level are candidates,
and a two-component 1-D Gaussian mixture fitted to their losses (10 fixed
EM iterations in float32, `gmm_split`) makes the candidates of the
low-loss component positives. An anchor two gts take goes to the one of
lower loss. PAA's GMM is per gt of one image, so several ranks need
nothing but the global positive count.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function

from ...core.bbox.iou import bbox_overlaps
from ...core.bbox.transforms import delta2bbox
from ...core.post.nms import topk_stable
from ...parallel.batch import batch_total
from ...utils.registry import DETECTORS
from ..dense_heads.anchor_head import DensePredictConfig
from ..losses import binary_cross_entropy, giou_loss, sigmoid_focal_loss
from ..losses.utils import jax_max
from .atss import _ATSSBase, anchor_centers
from .gfl import aligned_iou

BIG = 1e8


def gmm_split(losses: torch.Tensor, valid: torch.Tensor, iters: int = 10
              ) -> torch.Tensor:
    """A two-component 1-D GMM fitted to each row of `losses` (..., K) over
    its `valid` entries, by `iters` EM steps from means (min, max), unit
    variances and equal weights (variances clamped at 1e-6, weights at
    1e-12 under the log); returns the valid entries whose responsibility
    under the lower-mean component exceeds 0.5 (bool (..., K))."""
    x = torch.where(valid, losses, losses.new_tensor(BIG))
    lo = x.amin(-1, keepdim=True)
    hi = torch.where(valid, losses, losses.new_tensor(-BIG)).amax(
        -1, keepdim=True)
    mu = torch.cat([lo, hi], -1)                              # (..., 2)
    var = torch.ones_like(mu)
    pi = torch.full_like(mu, 0.5)
    v = valid[..., None].to(losses.dtype)
    xs = x[..., None]
    for _ in range(iters):
        var_c = jax_max(var, 1e-6)[..., None, :]
        logp = -0.5 * ((xs - mu[..., None, :]) ** 2 / var_c) \
            - 0.5 * torch.log(var_c) \
            + torch.log(jax_max(pi, 1e-12)[..., None, :])
        r = torch.softmax(logp, dim=-1) * v                  # (..., K, 2)
        nk = jax_max(r.sum(-2), 1e-6)                         # (..., 2)
        mu = (r * xs).sum(-2) / nk
        var = jax_max((r * (xs - mu[..., None, :]) ** 2).sum(-2) / nk, 1e-6)
        pi = nk / jax_max(nk.sum(-1, keepdim=True), 1e-6)
    logp = -0.5 * ((xs - mu[..., None, :]) ** 2 / var[..., None, :]) \
        - 0.5 * torch.log(var[..., None, :]) \
        + torch.log(jax_max(pi, 1e-12)[..., None, :])
    r = torch.softmax(logp, dim=-1)
    low_is_0 = (mu[..., 0] <= mu[..., 1])[..., None]
    resp_low = torch.where(low_is_0, r[..., 0], r[..., 1])
    return (resp_low > 0.5) & valid


def paa_candidates(cand_loss: torch.Tensor,
                   num_level_anchors: Sequence[int], k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per gt row of `cand_loss` (..., G, N) over anchors in level order
    (`num_level_anchors` the levels' sizes), the `k` lowest losses of each
    level in `lax.top_k`'s order (ties to the lower index): (indices,
    losses, whether each is a real candidate, i.e. under 1e8), each
    (..., G, levels · k). A level of fewer than `k` anchors fills its
    places with other levels' anchors at 1e9, as the JAX package's masked
    top-k over all anchors does; they are never real."""
    idxs, vals, start = [], [], 0
    for n_l in num_level_anchors:
        if n_l >= k:
            v, ix = topk_stable(-cand_loss[..., start:start + n_l], k)
            ix = ix + start
        else:
            on = torch.zeros(cand_loss.shape[-1], dtype=torch.bool,
                             device=cand_loss.device)
            on[start:start + n_l] = True
            v, ix = topk_stable(torch.where(
                on, -cand_loss, cand_loss.new_tensor(-1e9)), k)
        idxs.append(ix)
        vals.append(v)
        start += n_l
    v = torch.cat(vals, -1)
    return torch.cat(idxs, -1), -v, v > -BIG


def paa_loss(cls, reg, iou_p, anchors, num_level_anchors: Sequence[int],
             batch, num_classes: int, topk: int,
             assign_cls: Optional[torch.Tensor] = None,
             assign_reg: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
    """PAA's losses over flat predictions: focal over every anchor, 1.3 x
    GIoU of the positives' decoded boxes, 0.5 x BCE of their IoU branch
    against the IoU of their detached boxes, all over the batch's
    positive count. `assign_cls` / `assign_reg` are the predictions that
    drive the assignment (a frozen teacher's, for LAD); by default the
    supervised ones. cls (B, N, C), reg (B, N, 4), iou_p (B, N, 1),
    anchors (N, 4) in level order, `num_level_anchors` the levels'
    sizes."""
    acls = cls if assign_cls is None else assign_cls
    areg = reg if assign_reg is None else assign_reg
    gt, gtv = batch['gt_bboxes'].float(), batch['gt_valid']
    gl = batch['gt_labels'].long().clamp(0, num_classes - 1)     # (B, G)
    b, n = cls.shape[:2]
    with torch.no_grad():
        p = torch.sigmoid(acls.detach().float())
        aboxes = delta2bbox(anchors, areg.detach().float())
        ious = bbox_overlaps(gt, aboxes)                          # (B, G, N)
        p_gt = torch.gather(p, 2, gl[:, None, :].expand(b, n, -1))
        cand_loss = -torch.log(jax_max(p_gt.transpose(1, 2), 1e-8)) \
            - torch.log(jax_max(ious, 1e-8))
        ctr = anchor_centers(anchors)
        inside = ((ctr[:, 0] >= gt[..., 0:1]) & (ctr[:, 0] <= gt[..., 2:3])
                  & (ctr[:, 1] >= gt[..., 1:2]) & (ctr[:, 1] <= gt[..., 3:4]))
        cand_loss = torch.where(inside & gtv[..., None], cand_loss,
                                cand_loss.new_tensor(BIG))
        cand_idx, cand_val, cand_ok = paa_candidates(
            cand_loss, num_level_anchors, topk)
        cand_ok = cand_ok & gtv[..., None]
        chosen = gmm_split(cand_val, cand_ok)                   # (B, G, LK)
        picked = torch.where(chosen, cand_val, cand_val.new_tensor(BIG))
        loss_at = torch.full((b, n), BIG, device=cls.device).scatter_reduce(
            1, cand_idx.reshape(b, -1), picked.reshape(b, -1), 'amin',
            include_self=True)
        per_gt = torch.full(ious.shape, BIG, device=cls.device).scatter_reduce(
            2, cand_idx, picked, 'amin', include_self=True)
        gt_at = torch.argmin(per_gt, dim=1)                       # (B, N)
        pos = loss_at < BIG / 2
    labels = torch.where(pos, torch.gather(gl, 1, gt_at),
                         torch.full_like(gt_at, num_classes))
    cls_l = sigmoid_focal_loss(cls, labels, reduction='sum')
    gt_m = torch.gather(gt, 1, gt_at[..., None].expand(b, n, 4))
    boxes = delta2bbox(anchors, reg.float())
    pos_f = pos.float()
    reg_l = giou_loss(boxes, gt_m, weight=pos_f, reduction='sum')
    iou_t = aligned_iou(boxes.detach(), gt_m)
    iou_l = binary_cross_entropy(iou_p[..., 0], iou_t, weight=pos_f,
                                 reduction='sum')
    denom = torch.clamp(batch_total(pos_f.sum()), min=1.0)
    return dict(loss_cls=cls_l / denom, loss_bbox=1.3 * reg_l / denom,
                loss_iou=0.5 * iou_l / denom)


@DETECTORS.register_module()
class PAA(_ATSSBase):
    """PAA: `paa_loss` on the ATSS head's outputs (its centerness branch
    the IoU branch); `predict` scores sigmoid(cls) · sqrt(sigmoid(iou))."""

    def __init__(self, num_classes: int = 80, backbone_depth: int = 50,
                 backbone_cfg: Any = None, frozen_stages: int = 1,
                 strides: Tuple[int, ...] = (8, 16, 32, 64, 128),
                 topk_per_level: int = 9,
                 test_cfg: DensePredictConfig = DensePredictConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__(num_classes, backbone_depth, backbone_cfg,
                         frozen_stages, strides, test_cfg, dtype)
        self.topk_per_level = topk_per_level

    def loss(self, batch, generator=None, sampler_priorities=None):
        cls, reg, iou_p, anchors, counts = self._flat(batch['image'])
        with record_function('step/dense_loss'):
            return paa_loss(cls, reg, iou_p, anchors, counts, batch,
                            self.num_classes, self.topk_per_level)

    @torch.inference_mode()
    def predict(self, batch):
        cls, reg, iou_p, anchors, _ = self._flat(batch['image'])
        return self._predict(
            torch.sigmoid(cls) * torch.sqrt(torch.sigmoid(iou_p)), reg,
            anchors, batch['img_shape'])
