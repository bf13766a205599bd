"""Batch collation (counterpart of the JAX package's `data/builder.py:collate`)."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def collate(samples: Sequence[dict]) -> Dict[str, torch.Tensor]:
    """Stack a list of `PackDetInputs` outputs into a batch dict of tensors,
    all on the device of the samples' `image`."""
    device = samples[0]['image'].device
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], torch.Tensor):
            out[k] = torch.stack(vals)
        else:
            out[k] = torch.as_tensor(np.stack(vals), device=device)
    return out
