"""Neck construction (counterpart of the JAX package's
`models/necks/build.py:make_fpn_neck`). Only the plain FPN is ported."""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from .fpn import FPN


def make_fpn_neck(neck_type: Optional[str], *, in_channels: Sequence[int],
                  out_channels: int = 256, num_outs: int = 5,
                  start_level: int = 0,
                  add_extra_convs: Union[bool, str] = False,
                  dtype: torch.dtype = torch.float32) -> FPN:
    """The FPN for `neck_type` 'FPN' (or None / ''), computed at `dtype`;
    every other neck raises."""
    if neck_type not in ('FPN', None, ''):
        raise NotImplementedError(f'neck_type {neck_type!r}: only the FPN '
                                  'neck is ported')
    return FPN(in_channels=tuple(in_channels), out_channels=out_channels,
               num_outs=num_outs, start_level=start_level,
               add_extra_convs=add_extra_convs, dtype=dtype)
