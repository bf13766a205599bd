"""Gradient reversal and scaling (counterpart of the JAX package's
`models/layers/grl.py`): identity forward, the incoming gradient times
`weight` backward (`weight = -1` reverses it)."""

from __future__ import annotations

import torch


class _GradientScalar(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight):
        ctx.weight = weight
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.weight, None


def gradient_scalar(x: torch.Tensor, weight: float) -> torch.Tensor:
    return _GradientScalar.apply(x, weight)


def gradient_reverse(x: torch.Tensor, weight: float = -1.0) -> torch.Tensor:
    """GRL: identity forward, `weight * grad` backward."""
    return gradient_scalar(x, weight)
