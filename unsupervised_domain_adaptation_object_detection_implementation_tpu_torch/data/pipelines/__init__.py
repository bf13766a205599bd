from .transforms import (Compose, LoadImageFromFile, Normalize, PackDetInputs,
                         Pad, Resize, imresize)

__all__ = ['Compose', 'LoadImageFromFile', 'Normalize', 'PackDetInputs',
           'Pad', 'Resize', 'imresize']
