"""Layer plugins (counterpart of the JAX package's
`models/layers/plugins.py`). Only `DeformConv` is ported: the
deformable convolution layer that FCOS's `dcn_on_last_conv` head uses.
The trunk's DCN, `ContextBlock` and `GeneralizedAttention` are not ported
yet."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...ops.deform_conv import batched_deform_conv2d


class DeformConv(nn.Module):
    """DCN v1 / v2 as a layer over `ops/deform_conv.py:
    batched_deform_conv2d` (mmcv's `DeformConv2d` / `ModulatedDeformConv2d`
    module form), with no bias. The offsets (and the v2 mask) come from a
    conv of the caller's, as in the JAX package. The kernel is `weight`
    (Co, C, kh, kw), as a conv's: the converter carries the JAX `kernel`
    (kh, kw, C, Co) across as it carries a conv's, and the forward hands
    the deformable conv its HWIO view, cast to `dtype`, as the JAX layer
    casts its f32 kernel. NHWC input and offsets, NHWC output."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: int = 3, stride: int = 1, dilation: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride = stride
        self.dilation = dilation
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            features, in_channels, kernel_size, kernel_size))

    @torch.no_grad()
    def init_he_(self, generator: torch.Generator) -> None:
        """flax's `he_normal`: N(0, 2 / fan_in)."""
        fan_in = self.weight[0].numel()
        self.weight.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=generator)

    def forward(self, x: torch.Tensor, offsets: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        k = self.weight.shape[-1]
        return batched_deform_conv2d(
            x.to(self.dtype), offsets,
            self.weight.permute(2, 3, 1, 0).to(self.dtype), None,
            stride=self.stride, padding=(self.dilation * (k - 1)) // 2,
            dilation=self.dilation, mask=mask)
