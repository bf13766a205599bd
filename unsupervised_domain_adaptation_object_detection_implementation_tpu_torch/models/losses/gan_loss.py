"""GAN losses of CyDA / CyCADA (counterpart of the JAX package's
`models/losses/gan_loss.py`): the least-squares GAN objective and the L1
cycle-consistency loss, as CycleGAN trains them. Each mean runs over the global batch under data
parallelism (`parallel/batch.py:batch_mean`)."""

from __future__ import annotations

import torch

from ...parallel.batch import batch_mean


def gan_lsgan_loss(logits: torch.Tensor, is_real: bool) -> torch.Tensor:
    """mean((D(x) − target)²), target 1 for real, 0 for fake."""
    target = 1.0 if is_real else 0.0
    return batch_mean((logits - target) ** 2)


def cycle_consistency_loss(x: torch.Tensor, x_rec: torch.Tensor,
                           weight: float = 10.0) -> torch.Tensor:
    """weight · mean |x − G_t2s(G_s2t(x))|."""
    return weight * batch_mean((x - x_rec).abs())
