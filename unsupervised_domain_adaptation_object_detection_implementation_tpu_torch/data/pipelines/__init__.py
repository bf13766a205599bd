from .auto_augment import AutoAugment
from .jpeg import decode_jpeg
from .polygon import fill_polygon, rasterize_polygons
from .transforms import (Compose, LoadAnnotations, LoadImageFromFile,
                         LoadProposals,
                         MultiScaleFlipAug, Normalize, PackDetInputs, Pad,
                         RandomCrop, RandomFlip, Resize, imresize)

__all__ = ['AutoAugment', 'Compose', 'LoadAnnotations', 'LoadImageFromFile',
           'LoadProposals',
           'MultiScaleFlipAug', 'Normalize', 'PackDetInputs', 'Pad',
           'RandomCrop', 'RandomFlip', 'Resize', 'decode_jpeg',
           'fill_polygon', 'imresize', 'rasterize_polygons']
