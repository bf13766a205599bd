"""Attention blocks of the DA heads (counterpart of the JAX package's
`models/layers/attention.py`: `CBAM` and `NonLocalBlock`; `MHSA` waits for
the Tri-attention variant)."""

from __future__ import annotations

import torch
from torch import nn


class CBAM(nn.Module):
    """Channel then spatial attention on an NCHW map. The spatial conv pads
    as flax's default 'SAME' does (k // 2 for odd k)."""

    def __init__(self, channels: int, reduction: int = 16,
                 spatial_kernel: int = 7):
        super().__init__()
        self.mlp_reduce = nn.Conv2d(channels, channels // reduction, 1,
                                    bias=False)
        self.mlp_expand = nn.Conv2d(channels // reduction, channels, 1,
                                    bias=False)
        self.spatial = nn.Conv2d(2, 1, spatial_kernel,
                                 padding=spatial_kernel // 2, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        max_pool = x.amax(dim=(2, 3), keepdim=True)
        avg_pool = x.mean(dim=(2, 3), keepdim=True)
        ch_att = torch.sigmoid(
            self.mlp_expand(torch.relu(self.mlp_reduce(max_pool))) +
            self.mlp_expand(torch.relu(self.mlp_reduce(avg_pool))))
        x = x * ch_att
        sp = torch.cat([x.amax(dim=1, keepdim=True),
                        x.mean(dim=1, keepdim=True)], dim=1)
        return x * torch.sigmoid(self.spatial(sp))


class NonLocalBlock(nn.Module):
    """Embedded-gaussian non-local over a token set: (N, C) → (N, C) with a
    residual."""

    def __init__(self, channels: int):
        super().__init__()
        inter = channels // 2
        self.phi = nn.Linear(channels, inter, bias=False)
        self.theta = nn.Linear(channels, inter, bias=False)
        self.g = nn.Linear(channels, inter, bias=False)
        self.out = nn.Linear(inter, channels, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        attn = torch.softmax(self.theta(x) @ self.phi(x).T, dim=-1)
        return x + self.out(attn @ self.g(x))
