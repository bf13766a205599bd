"""Attention blocks of the DA heads (counterpart of the JAX package's
`models/layers/attention.py`: `CBAM`, `NonLocalBlock` and `MHSA`).

They have no compute type of their own, as in the JAX package: their
convs and linears (`precision.py`) run in f32 and upcast a bf16 input."""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from .precision import Conv2d, Linear


class CBAM(nn.Module):
    """Channel then spatial attention on an NCHW map. The spatial conv pads
    as flax's default 'SAME' does (k // 2 for odd k)."""

    def __init__(self, channels: int, reduction: int = 16,
                 spatial_kernel: int = 7):
        super().__init__()
        self.mlp_reduce = Conv2d(channels, channels // reduction, 1,
                                 bias=False)
        self.mlp_expand = Conv2d(channels // reduction, channels, 1,
                                 bias=False)
        self.spatial = Conv2d(2, 1, spatial_kernel,
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
        self.phi = Linear(channels, inter, bias=False)
        self.theta = Linear(channels, inter, bias=False)
        self.g = Linear(channels, inter, bias=False)
        self.out = Linear(inter, channels, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        attn = torch.softmax(self.theta(x) @ self.phi(x).T, dim=-1)
        return x + self.out(attn @ self.g(x))


class MHSA(nn.Module):
    """Multi-head self-attention over the pixels of an NCHW map with 2D
    relative position terms: 1x1 q/k/v convs, logits q·kᵀ + q·posᵀ with
    pos = rel_h + rel_w, softmax of the logits over √dh, then the weighted
    v. `rel_h` (h, 1, c) and `rel_w` (1, w, c) are raw parameters in the
    JAX layout, so the map size is fixed when the module is built
    (`map_hw`); the JAX module draws them from the first batch it sees. A
    map of another size raises. Channels split into heads head-major, as
    the JAX reshape (c → heads, dh) does."""

    def __init__(self, channels: int, map_hw: Tuple[int, int],
                 num_heads: int = 4):
        super().__init__()
        self.num_heads = num_heads
        self.map_hw = tuple(map_hw)
        h, w = self.map_hw
        self.q = Conv2d(channels, channels, 1)
        self.k = Conv2d(channels, channels, 1)
        self.v = Conv2d(channels, channels, 1)
        self.rel_h = nn.Parameter(torch.zeros(h, 1, channels))
        self.rel_w = nn.Parameter(torch.zeros(1, w, channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        if (h, w) != self.map_hw:
            raise ValueError(f'MHSA built for a {self.map_hw} map, given '
                             f'{(h, w)}: its relative position parameters '
                             'have the map size of the training canvas')
        heads = self.num_heads
        dh = c // heads

        def split(t):                                  # → (B, heads, HW, dh)
            return t.reshape(b, heads, dh, h * w).transpose(2, 3)

        qs, ks, vs = split(self.q(x)), split(self.k(x)), split(self.v(x))
        pos = (self.rel_h + self.rel_w).reshape(h * w, heads, dh)
        logits = qs @ ks.transpose(2, 3) + \
            torch.einsum('bhqd,khd->bhqk', qs, pos)
        attn = torch.softmax(logits / math.sqrt(dh), dim=-1)
        out = attn @ vs                                # (B, heads, HW, dh)
        return out.transpose(2, 3).reshape(b, c, h, w)
