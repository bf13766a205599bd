from .coco import CocoDataset
from .custom import CustomDataset
from .wrappers import ConcatDataset, RepeatDataset
from .xml_style import (CITYSCAPES_DA_CLASSES, DADataset, VOCDataset,
                        XMLDataset)

__all__ = ['CITYSCAPES_DA_CLASSES', 'CocoDataset', 'ConcatDataset',
           'CustomDataset', 'DADataset', 'RepeatDataset', 'VOCDataset',
           'XMLDataset']
