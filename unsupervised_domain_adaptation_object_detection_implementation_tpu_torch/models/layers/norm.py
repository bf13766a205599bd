"""Frozen BatchNorm (counterpart of the JAX package's
`models/layers/norm.py:FrozenBatchNorm`).

The trunk runs with `norm_eval=True`: running statistics never change, the
affine scale/bias are parameters. Parameter and buffer names (`scale`,
`bias`, `mean`, `var`) are the flax ones, so converted weights load by name.
"""

from __future__ import annotations

import torch
from torch import nn


class FrozenBatchNorm(nn.Module):
    """y = x * mul + off with mul = scale / sqrt(var + eps) and
    off = bias - mean * mul, computed in f32 over the channel dim (dim 1)."""

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.features = features
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('mean', torch.zeros(features))
        self.register_buffer('var', torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = self.scale / torch.sqrt(self.var + self.epsilon)
        off = self.bias - self.mean * mul
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * mul.to(x.dtype).view(shape) + off.to(x.dtype).view(shape)
