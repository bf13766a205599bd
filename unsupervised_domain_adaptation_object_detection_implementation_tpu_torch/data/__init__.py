from .builder import collate

__all__ = ['collate']
