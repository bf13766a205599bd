"""Loss weighting and reduction (counterpart of the JAX package's
`models/losses/utils.py`).

Padded targets carry weight 0 and `avg_factor` is the count of real
samples, so one static-shape code path serves every batch.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def one_hot(labels: torch.Tensor, num_classes: int,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """`jax.nn.one_hot`: a label outside [0, num_classes) (the background
    label num_classes, or -1) gives an all-zero row."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels[..., None] == classes).to(dtype)


def jax_abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with `jnp.abs`'s gradient at 0, +1 (torch's `abs` gives 0)."""
    return torch.where(x >= 0, x, -x)


def jax_max(x: torch.Tensor, floor: float) -> torch.Tensor:
    """max(x, floor) with `jnp.maximum`'s gradient where x == floor, one
    half (torch's `clamp` gives 1)."""
    return torch.maximum(x, x.new_tensor(floor))


def jax_clip(x: torch.Tensor, lo: Optional[float] = None,
             hi: Optional[float] = None) -> torch.Tensor:
    """`jnp.clip(x, lo, hi)`, a maximum then a minimum, with their gradient
    at a bound, one half (torch's `clamp` gives 1)."""
    if lo is not None:
        x = torch.maximum(x, x.new_tensor(lo))
    if hi is not None:
        x = torch.minimum(x, x.new_tensor(hi))
    return x


def reduce_loss(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == 'none':
        return loss
    if reduction == 'mean':
        return loss.mean()
    if reduction == 'sum':
        return loss.sum()
    raise ValueError(reduction)


def weight_reduce_loss(loss: torch.Tensor,
                       weight: Optional[torch.Tensor] = None,
                       reduction: str = 'mean',
                       avg_factor: Union[torch.Tensor, float, None] = None,
                       eps: float = 1e-12) -> torch.Tensor:
    """loss * weight, then reduce; `avg_factor` replaces the mean's
    denominator."""
    if weight is not None:
        loss = loss * weight
    if avg_factor is None:
        return reduce_loss(loss, reduction)
    if reduction == 'mean':
        return loss.sum() / torch.clamp(torch.as_tensor(
            avg_factor, dtype=loss.dtype, device=loss.device), min=eps)
    if reduction == 'none':
        return loss
    if reduction == 'sum':
        return loss.sum()
    raise ValueError(reduction)
