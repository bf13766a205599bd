"""Training hooks as functions of the train step (counterpart of the JAX
package's `apis/hooks.py`): the EMA of the parameters and the guard that
skips a non-finite update.

Both take dicts of tensors keyed by parameter name. `ema_update` updates the
shadow in place (it is the step's own buffer); the guard returns new
tensors and leaves its inputs alone.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch


@torch.no_grad()
def ema_update(ema_params: Dict[str, torch.Tensor],
               params: Dict[str, torch.Tensor], momentum: float = 0.9998,
               step: Optional[int] = None, gamma: float = 2000.0
               ) -> Dict[str, torch.Tensor]:
    """ema ← ema·m + p·(1 − m), in place; `momentum` is the decay (the old
    value's weight). With `step` (the count before this update) the decay
    ramps up as m = momentum·(1 − exp(−(step + 1)/gamma)), so early steps
    copy the parameters almost exactly."""
    m = momentum if step is None else \
        momentum * (1.0 - math.exp(-(step + 1.0) / gamma))
    names = list(ema_params)
    es = [ema_params[n] for n in names]
    torch._foreach_mul_(es, m)
    torch._foreach_add_(es, [params[n].detach() for n in names],
                        alpha=1.0 - m)
    return ema_params


@torch.no_grad()
def guard_nonfinite_update(old_params: Dict[str, torch.Tensor],
                           new_params: Dict[str, torch.Tensor],
                           loss: torch.Tensor
                           ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Keep the old parameters when the loss or any new parameter is not
    finite (one sum over all new parameters is non-finite iff one of them
    is). Returns (params, skipped), with no read-back to the host."""
    total = torch.stack([p.float().sum() for p in new_params.values()]).sum()
    ok = torch.isfinite(loss) & torch.isfinite(total)
    params = {n: new if new is old_params[n] else
              torch.where(ok, new, old_params[n])
              for n, new in new_params.items()}
    return params, ~ok
