"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = 'cuda') -> torch.device:
    """Return `device` as a `torch.device`, refusing CUDA without a card.

    Entry points default to CUDA; a caller that wants the CPU says so with
    `device='cpu'`. There is no silent fallback to the CPU.
    """
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f'device {str(dev)!r} requested but torch.cuda.is_available() is '
            "False; pass device='cpu' to run on the CPU")
    return dev
