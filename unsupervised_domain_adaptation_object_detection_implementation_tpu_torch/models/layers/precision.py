"""Compute precision of the port's modules (the JAX package's `dtype`
module argument).

The JAX package computes a flax module at `dtype` by casting its input and
its kernel (and bias) to it (`flax.linen.dtypes.promote_dtype`); the
parameters stay float32, so their gradients, the momentum and the EMA do
too. `Conv2d` and `Linear` do the same here with `compute_dtype`, keeping
`nn.Conv2d`'s and `nn.Linear`'s parameter names (converted weights load
unchanged). At float32, the default, an f32 input passes through
untouched, and a bf16 input is upcast: a module the JAX package builds
without a `dtype` (the DA heads) promotes bf16 features and f32
parameters to f32, and so does its counterpart here.

`compute_dtype(value)` reads the `dtype` of a model config.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

_COMPUTE_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def compute_dtype(value: Any = None) -> torch.dtype:
    """The torch dtype a config's `dtype` names (None → float32): the
    strings 'float32' and 'bfloat16' (`--cfg-options model.dtype=bfloat16`)
    or those torch dtypes. float16 raises: only the f32 and bf16 compute
    paths are ported."""
    if value is None:
        return torch.float32
    name = str(value).replace('torch.', '')
    if name == 'float16':
        raise NotImplementedError(
            f'dtype {value!r}: float16 compute is not ported, only float32 '
            'and bfloat16 (model.dtype=bfloat16, or an `fp16` config block, '
            'which trains in bf16); float16 is queued in ROADMAP.md Queue 1')
    if name not in _COMPUTE_DTYPES:
        raise ValueError(f'dtype {value!r}: one of {sorted(_COMPUTE_DTYPES)}')
    return _COMPUTE_DTYPES[name]


def _add_bias(y: torch.Tensor, bias, shape) -> torch.Tensor:
    """y + bias in y's type, as flax adds a bias after its product."""
    return y if bias is None else y + bias.to(y.dtype).view(shape)


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` computed at `compute_dtype`: input, weight and bias cast
    to it, the output in it. At float32 the bias is fused into the
    convolution, as `nn.Conv2d` does; at bf16 it is added after it, so the
    product is rounded to bf16 before the bias is added, as in flax."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32:
            return super().forward(x.to(dt))
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        return _add_bias(y, self.bias, (1, -1, 1, 1))


class Linear(nn.Linear):
    """`nn.Linear` computed at `compute_dtype`: input, weight and bias cast
    to it, the output in it; at bf16 the bias is added after the product,
    as `Conv2d` adds it."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32:
            return super().forward(x.to(dt))
        y = F.linear(x.to(dt), self.weight.to(dt))
        return _add_bias(y, self.bias, (-1,))


class Conv1d(nn.Conv1d):
    """`nn.Conv1d` computed at `compute_dtype`, as `Conv2d`."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32:
            return super().forward(x.to(dt))
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        return _add_bias(y, self.bias, (1, -1, 1))


class ConvTranspose1d(nn.ConvTranspose1d):
    """`nn.ConvTranspose1d` computed at `compute_dtype`, as `Conv2d`."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32:
            return super().forward(x.to(dt))
        y = F.conv_transpose1d(x.to(dt), self.weight.to(dt), None,
                               self.stride, self.padding,
                               self.output_padding, self.groups,
                               self.dilation)
        return _add_bias(y, self.bias, (1, -1, 1))
