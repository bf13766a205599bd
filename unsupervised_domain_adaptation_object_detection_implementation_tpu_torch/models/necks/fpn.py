"""Feature Pyramid Network (counterpart of the JAX package's
`models/necks/fpn.py:FPN`).

Lateral 1x1 projections, a nearest top-down merge and 3x3 smoothing, then
the extra levels: a 1x1 max-pool with stride 2 (Faster R-CNN's P6), or
stride-2 3x3 convs on the last input or output (`add_extra_convs`).

NCHW tensors. Module names mirror the flax tree (`lateral_{i}`,
`fpn_conv_{i}`, `extra_conv_{i}`), so a flax variable tree converts by
renaming.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.registry import NECKS
from ..layers.precision import Conv2d


@NECKS.register_module()
class FPN(nn.Module):
    """`in_channels` are the trunk stages' widths; `num_outs` levels come
    out, the ones beyond the inputs made by `add_extra_convs` (False |
    'on_input' | 'on_output'). Every conv computes at `dtype`."""

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5,
                 start_level: int = 0,
                 add_extra_convs: Union[bool, str] = False,
                 relu_before_extra_convs: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if add_extra_convs not in (False, 'on_input', 'on_output'):
            raise ValueError(f'add_extra_convs {add_extra_convs!r}: one of '
                             "False, 'on_input', 'on_output'")
        self.in_channels = tuple(in_channels)
        self.num_outs = num_outs
        self.start_level = start_level
        self.add_extra_convs = add_extra_convs
        self.relu_before_extra_convs = relu_before_extra_convs
        used = self.in_channels[start_level:]
        conv = functools.partial(Conv2d, compute_dtype=dtype)
        for i, c in enumerate(used):
            self.add_module(f'lateral_{i}', conv(c, out_channels, 1))
            self.add_module(f'fpn_conv_{i}',
                            conv(out_channels, out_channels, 3, padding=1))
        if add_extra_convs:
            for i in range(max(num_outs - len(used), 0)):
                c = used[-1] if i == 0 and add_extra_convs == 'on_input' \
                    else out_channels
                self.add_module(f'extra_conv_{i}',
                                conv(c, out_channels, 3, stride=2,
                                     padding=1))

    def forward(self, inputs: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, ...]:
        """inputs: the trunk's (B, C_i, H_i, W_i) stages → `num_outs`
        (B, out_channels, H_l, W_l) levels, finest first."""
        if len(inputs) != len(self.in_channels):
            raise ValueError(f'{len(inputs)} inputs for '
                             f'{len(self.in_channels)} in_channels')
        used = inputs[self.start_level:]
        laterals = [getattr(self, f'lateral_{i}')(x)
                    for i, x in enumerate(used)]
        for i in range(len(laterals) - 1, 0, -1):
            # half-pixel nearest, as `jax.image.resize(..., 'nearest')`;
            # torch's plain 'nearest' floors without the half pixel
            laterals[i - 1] = laterals[i - 1] + F.interpolate(
                laterals[i], size=laterals[i - 1].shape[-2:],
                mode='nearest-exact')
        outs = [getattr(self, f'fpn_conv_{i}')(x)
                for i, x in enumerate(laterals)]
        extra = self.num_outs - len(outs)
        if extra > 0 and not self.add_extra_convs:
            for _ in range(extra):
                # flax max_pool((1, 1), strides (2, 2)), VALID padding
                outs.append(F.max_pool2d(outs[-1], 1, 2))
        elif extra > 0:
            src = used[-1] if self.add_extra_convs == 'on_input' \
                else outs[-1]
            for i in range(extra):
                if i > 0 and self.relu_before_extra_convs:
                    src = torch.relu(src)
                src = getattr(self, f'extra_conv_{i}')(src)
                outs.append(src)
        return tuple(outs)
