"""The CycleGAN of CyDA / CyCADA (counterpart of the JAX package's
`models/da/cyclegan.py`): a ResNet generator and a PatchGAN discriminator
on NCHW maps, with the JAX module names, so converted weights load by name.

Every conv has a bias (flax's default) and explicit padding as in the JAX
module; the norm is `InstanceNorm`, flax's `GroupNorm` with one channel a
group. The generator upsamples with nearest 2x (each pixel repeated, as
`jax.image.resize(..., 'nearest')` does at exactly twice the size) and a
3x3 conv, not a transposed conv.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..layers.norm import InstanceNorm


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, C, 2H, 2W), output pixel (i, j) = input pixel
    (i // 2, j // 2)."""
    return F.interpolate(x, scale_factor=2, mode='nearest')


class ResnetGenerator(nn.Module):
    """c7s1-64, d128, d256, R256 × `n_blocks`, u128, u64, c7s1-3, tanh
    (the CycleGAN paper's generator); the output is in (−1, 1)."""

    def __init__(self, base: int = 64, n_blocks: int = 6):
        super().__init__()
        b = base
        self.n_blocks = n_blocks
        self.enc0 = nn.Conv2d(3, b, 7, padding=3)
        self.in0 = InstanceNorm(b)
        self.enc1 = nn.Conv2d(b, b * 2, 3, stride=2, padding=1)
        self.in1 = InstanceNorm(b * 2)
        self.enc2 = nn.Conv2d(b * 2, b * 4, 3, stride=2, padding=1)
        self.in2 = InstanceNorm(b * 4)
        for i in range(n_blocks):
            self.add_module(f'res{i}_conv1', nn.Conv2d(b * 4, b * 4, 3,
                                                       padding=1))
            self.add_module(f'res{i}_in1', InstanceNorm(b * 4))
            self.add_module(f'res{i}_conv2', nn.Conv2d(b * 4, b * 4, 3,
                                                       padding=1))
            self.add_module(f'res{i}_in2', InstanceNorm(b * 4))
        self.dec0 = nn.Conv2d(b * 4, b * 2, 3, padding=1)
        self.dec0_in = InstanceNorm(b * 2)
        self.dec1 = nn.Conv2d(b * 2, b, 3, padding=1)
        self.dec1_in = InstanceNorm(b)
        self.out = nn.Conv2d(b, 3, 7, padding=3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 3, H, W) with H and W multiples of 4 → (B, 3, H, W)."""
        h = torch.relu(self.in0(self.enc0(x)))
        h = torch.relu(self.in1(self.enc1(h)))
        h = torch.relu(self.in2(self.enc2(h)))
        for i in range(self.n_blocks):
            r = torch.relu(getattr(self, f'res{i}_in1')(
                getattr(self, f'res{i}_conv1')(h)))
            r = getattr(self, f'res{i}_in2')(getattr(self, f'res{i}_conv2')(r))
            h = h + r
        for conv, norm in ((self.dec0, self.dec0_in),
                           (self.dec1, self.dec1_in)):
            h = torch.relu(norm(conv(upsample_nearest_2x(h))))
        return torch.tanh(self.out(h))


class PatchDiscriminator(nn.Module):
    """70x70 PatchGAN: C64 (no norm) − C128 − C256, 4x4 stride 2, then C512
    4x4 stride 1, leaky ReLU 0.2, then a 4x4 conv to one logit per patch;
    every 4x4 conv padded by 1."""

    def __init__(self, base: int = 64):
        super().__init__()
        chans = (3, base, base * 2, base * 4)
        for i in range(3):
            self.add_module(f'conv{i}', nn.Conv2d(chans[i], chans[i + 1], 4,
                                                  stride=2, padding=1))
            if i > 0:
                self.add_module(f'in{i}', InstanceNorm(chans[i + 1]))
        self.conv3 = nn.Conv2d(base * 4, base * 8, 4, padding=1)
        self.in3 = InstanceNorm(base * 8)
        self.out = nn.Conv2d(base * 8, 1, 4, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 3, H, W) → (B, 1, H', W') logits."""
        h = x
        for i in range(3):
            h = getattr(self, f'conv{i}')(h)
            if i > 0:
                h = getattr(self, f'in{i}')(h)
            h = F.leaky_relu(h, 0.2)
        h = F.leaky_relu(self.in3(self.conv3(h)), 0.2)
        return self.out(h)
