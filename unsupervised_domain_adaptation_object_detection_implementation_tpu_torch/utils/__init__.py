from .config import Config
from .device import resolve_device
from .registry import Registry

__all__ = ['Config', 'Registry', 'resolve_device']
