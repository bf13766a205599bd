"""Norms (counterpart of the JAX package's `models/layers/norm.py`).

- `FrozenBatchNorm`: the trunk runs with `norm_eval=True`; running
  statistics never change, the affine scale/bias are parameters.
- `BatchNorm`: the live norm of the DA heads, with `flax.linen.BatchNorm`'s
  semantics (the JAX heads use flax's module directly).
- `InstanceNorm`: the CycleGAN's norm, `flax.linen.GroupNorm` with one
  channel a group (JAX `models/da/cyclegan.py:_inorm`).
- `LayerNorm`: the Swin trunk's norm, `flax.linen.LayerNorm` over the last
  dim.

Parameter and buffer names (`scale`, `bias`, `mean`, `var`) are the flax
ones, so converted weights and `batch_stats` load by name.
"""

from __future__ import annotations

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


class InstanceNorm(nn.Module):
    """Instance norm with `flax.linen.GroupNorm(num_groups=None,
    group_size=1)`'s numerics, the CycleGAN's norm: per image and channel
    over the spatial dims, the fast variance E[x²] − E[x]² clamped at 0,
    ε 1e-6 (torch's `GroupNorm`/`InstanceNorm2d` use 1e-5 and the two-pass
    variance), then y = (x − mean) · rsqrt(var + ε) · scale + bias, in f32
    at least (f64 stays f64, as in flax). Channels are dim 1."""

    def __init__(self, features: int, epsilon: float = 1e-6):
        super().__init__()
        self.features = features
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        dims = tuple(range(2, x.dim()))
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(dims, keepdim=True)
        var = torch.clamp((xf * xf).mean(dims, keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.scale.view(shape)
        return ((xf - mean) * mul + self.bias.view(shape)).to(x.dtype)


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
