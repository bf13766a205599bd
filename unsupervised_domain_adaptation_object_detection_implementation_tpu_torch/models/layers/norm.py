"""Norms (counterpart of the JAX package's `models/layers/norm.py`).

- `FrozenBatchNorm`: the trunk runs with `norm_eval=True`; running
  statistics never change, the affine scale/bias are parameters.
- `BatchNorm`: the live norm of the DA heads, with `flax.linen.BatchNorm`'s
  semantics (the JAX heads use flax's module directly).
- `GroupNorm`: `flax.linen.GroupNorm`'s numerics, Grid R-CNN's head norm
  (JAX `models/detectors/roi_variants.py:GridHead`, 8 groups, statistics
  over every RoI of an image); `InstanceNorm` is its one-channel-a-group
  case, the CycleGAN's norm (JAX `models/da/cyclegan.py:_inorm`).
- `LayerNorm`: the Swin trunk's norm, `flax.linen.LayerNorm` over the last
  dim.

Parameter and buffer names (`scale`, `bias`, `mean`, `var`) are the flax
ones, so converted weights and `batch_stats` load by name.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...parallel.batch import batch_moments


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


class BatchNorm(nn.Module):
    """Live BatchNorm with `flax.linen.BatchNorm` semantics, the DA heads'
    norm: batch statistics in training, running ones in eval.

    Where it differs from `torch.nn.BatchNorm2d`: `momentum` is the weight
    of the OLD running value (0.99 here, torch's 0.01); the running variance
    takes the biased batch variance, computed as E[x²] − E[x]² clamped at 0
    (flax's fast variance); the statistics and the normalisation are in f32.
    Channels are dim 1; every other dim is reduced, and under data
    parallelism over the global batch (`parallel/batch.py:batch_moments`),
    so the running statistics move alike on every rank.
    """

    def __init__(self, features: int, momentum: float = 0.99,
                 epsilon: float = 1e-5):
        super().__init__()
        self.features = features
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('mean', torch.zeros(features))
        self.register_buffer('var', torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xf = x.float()
        if self.training:
            dims = [d for d in range(x.dim()) if d != 1]
            mean, mean_sq = batch_moments(xf, dims)
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
                self.var.mul_(m).add_(var.detach(), alpha=1.0 - m)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class GroupNorm(nn.Module):
    """`flax.linen.GroupNorm(num_groups=...)` (or `group_size=...`) with
    flax's numerics: the statistics of each group over every dim but the
    first (the sample) and the channel dim `channel_dim`, the fast variance
    E[x²] − E[x]² clamped at 0, ε 1e-6 (torch's `GroupNorm` and
    `InstanceNorm2d` use 1e-5 and the two-pass variance), then y = (x −
    mean) · (rsqrt(var + ε) · scale) + bias, all in f32 at least (f64
    stays f64). Like flax's module without a `dtype`, the result keeps that
    type: a bf16 input gives f32.

    flax reduces every dim between the first and the channels, so a (B, S,
    h, w, C) RoI stack is normalised per image over all S RoIs: pass it as
    (B, S, C, h, w) with `channel_dim=2`."""

    def __init__(self, features: int, num_groups: Optional[int] = None,
                 group_size: Optional[int] = None, epsilon: float = 1e-6,
                 channel_dim: int = 1):
        super().__init__()
        if (num_groups is None) == (group_size is None):
            raise ValueError('give one of num_groups and group_size')
        self.features = features
        self.num_groups = num_groups or features // group_size
        if features % self.num_groups:
            raise ValueError(f'{self.num_groups} groups do not divide '
                             f'{features} channels')
        self.epsilon = epsilon
        self.channel_dim = channel_dim
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd, g = self.channel_dim, self.num_groups
        shape = x.shape
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        xg = xf.reshape(*shape[:cd], g, shape[cd] // g, *shape[cd + 1:])
        dims = tuple(d for d in range(1, xg.dim()) if d != cd)
        mean = xg.mean(dims, keepdim=True)
        var = torch.clamp((xg * xg).mean(dims, keepdim=True) - mean * mean,
                          min=0.0)
        affine = (1,) * cd + (g, shape[cd] // g) + (1,) * (len(shape) - cd - 1)
        mul = torch.rsqrt(var + self.epsilon) * self.scale.view(affine)
        y = (xg - mean) * mul + self.bias.view(affine)
        return y.reshape(shape)


class InstanceNorm(GroupNorm):
    """Instance norm with `flax.linen.GroupNorm(num_groups=None,
    group_size=1)`'s numerics, the CycleGAN's norm: per image and channel
    over the spatial dims (channels are dim 1), as `GroupNorm`."""

    def __init__(self, features: int, epsilon: float = 1e-6):
        super().__init__(features, group_size=1, epsilon=epsilon)


class LayerNorm(nn.Module):
    """`flax.linen.LayerNorm` over the last dim, the Swin trunk's norm:
    the fast variance E[x²] − E[x]² clamped at 0, ε 1e-6 (torch's
    `nn.LayerNorm` takes 1e-5 and the two-pass variance), y = (x − mean) ·
    rsqrt(var + ε) · scale + bias with the statistics and the
    normalisation in f32 at least, then cast to `dtype`, the compute type
    (flax's `dtype`), whatever the input's. The means are sums times 1/n,
    as XLA computes `mean`: on features with a large mean the fast
    variance keeps the rounding of E[x]², and a division would round
    otherwise."""

    epsilon = 1e-6

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features = features
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        inv_n = 1.0 / x.shape[-1]
        mean = xf.sum(-1, keepdim=True) * inv_n
        var = torch.clamp((xf * xf).sum(-1, keepdim=True) * inv_n
                          - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return ((xf - mean) * mul + self.bias).to(self.dtype)
