from .jpeg import decode_jpeg
from .transforms import (Compose, LoadAnnotations, LoadImageFromFile,
                         MultiScaleFlipAug, Normalize, PackDetInputs, Pad,
                         RandomFlip, Resize, imresize)

__all__ = ['Compose', 'LoadAnnotations', 'LoadImageFromFile',
           'MultiScaleFlipAug', 'Normalize', 'PackDetInputs', 'Pad',
           'RandomFlip', 'Resize', 'decode_jpeg', 'imresize']
