from .custom import CustomDataset
from .wrappers import ConcatDataset
from .xml_style import (CITYSCAPES_DA_CLASSES, DADataset, VOCDataset,
                        XMLDataset)

__all__ = ['CITYSCAPES_DA_CLASSES', 'ConcatDataset', 'CustomDataset',
           'DADataset', 'VOCDataset', 'XMLDataset']
