"""Helpers of the multi-level dense heads (counterpart of the JAX package's
`models/dense_heads/anchor_head.py`): only `flatten_level_preds` is
ported."""

from __future__ import annotations

from typing import Sequence

import torch


def flatten_level_preds(preds: Sequence[torch.Tensor], channels: int
                        ) -> torch.Tensor:
    """[(B, H_i, W_i, A*channels)] NHWC → (B, ΣH_i·W_i·A, channels), each
    level location-major, anchor-minor, the levels in order."""
    b = preds[0].shape[0]
    return torch.cat([p.reshape(b, -1, channels) for p in preds], dim=1)
