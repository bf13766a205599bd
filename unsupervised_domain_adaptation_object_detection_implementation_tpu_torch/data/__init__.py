from . import datasets  # noqa: F401  (registers the datasets)
from .builder import DataLoader, build_dataloader, build_dataset, collate

__all__ = ['DataLoader', 'build_dataloader', 'build_dataset', 'collate']
