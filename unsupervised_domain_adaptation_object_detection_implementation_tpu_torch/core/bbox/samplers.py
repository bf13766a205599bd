"""Static-shape random positive/negative sampling (torch counterpart of the
JAX package's `core/bbox/samplers.py:random_sample`).

Every candidate gets a priority; a group's selection is the members above
the quota-th largest priority. The same priority vector ranks positives and
negatives. Priorities are drawn from a `torch.Generator` unless the caller
passes them (the parity tests pass the JAX package's
`jax.random.uniform` draws). Leading batch dims are taken as they come;
under data parallelism a rank draws its rows of the global batch's draw
(`parallel/batch.py:draw_rows`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from ...parallel.batch import draw_rows
from ..post.nms import topk_stable


class SampleResult(NamedTuple):
    inds: torch.Tensor       # (..., num) int64 indices into candidates
    is_pos: torch.Tensor     # (..., num) bool
    valid: torch.Tensor      # (..., num) bool: the slot holds a sample
    pos_mask: torch.Tensor   # (..., N) bool over candidates
    neg_mask: torch.Tensor   # (..., N) bool over candidates


def _select_top(mask: torch.Tensor, priority: torch.Tensor,
                quota: Union[int, torch.Tensor], k_static: int
                ) -> torch.Tensor:
    """Mask of the min(quota, count(mask)) members of `mask` with the
    largest priority: those at or above the quota-th largest masked
    priority (`k_static` >= the largest quota)."""
    key = torch.where(mask, priority, priority.new_tensor(float('-inf')))
    k_static = min(k_static, key.shape[-1])
    vals = torch.topk(key, k_static, dim=-1).values
    quota = torch.as_tensor(quota, device=key.device)
    pick = (quota - 1).clamp(0, k_static - 1).expand(key.shape[:-1])
    thr = torch.gather(vals, -1, pick[..., None])
    return mask & (key >= thr) & (quota > 0)[..., None]


def random_sample(assigned_gt_inds: torch.Tensor,
                  num: int,
                  pos_fraction: float,
                  neg_pos_ub: int = -1,
                  priorities: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> SampleResult:
    """Sample `num` slots from assignments (..., N): exactly
    min(#pos, num * pos_fraction) positives (assigned > 0) by priority, and
    negatives (assigned == 0) fill the rest. `priorities` (..., N) in
    [0, 1) replace the uniform draw from `generator`."""
    n = assigned_gt_inds.shape[-1]
    pos = assigned_gt_inds > 0
    neg = assigned_gt_inds == 0
    if priorities is None:
        priorities = draw_rows(
            lambda shape: torch.rand(shape, generator=generator,
                                     device=assigned_gt_inds.device),
            assigned_gt_inds.shape)
    r = priorities.float()

    num_expected_pos = int(num * pos_fraction)
    pos_sel = _select_top(pos, r, num_expected_pos, num_expected_pos)
    num_pos = pos_sel.sum(dim=-1)
    neg_quota = num - num_pos
    if neg_pos_ub >= 0:
        neg_quota = torch.minimum(neg_quota,
                                  num_pos.clamp(min=1) * neg_pos_ub)
    neg_sel = _select_top(neg, r, neg_quota, num)

    selected = pos_sel | neg_sel
    # fixed-size index extraction: positives, then negatives, then junk
    sort_key = torch.where(pos_sel, 3.0, torch.where(neg_sel, 2.0, 0.0)) + r
    k = min(num, n)
    inds = topk_stable(sort_key, k)[1]
    is_pos = torch.gather(pos_sel, -1, inds)
    valid = torch.gather(selected, -1, inds)
    if k < num:      # fewer candidates than slots: zero-pad, masked invalid
        pad = (0, num - k)
        inds = torch.nn.functional.pad(inds, pad)
        is_pos = torch.nn.functional.pad(is_pos, pad)
        valid = torch.nn.functional.pad(valid, pad)
    return SampleResult(inds, is_pos, valid, pos_sel, neg_sel)
