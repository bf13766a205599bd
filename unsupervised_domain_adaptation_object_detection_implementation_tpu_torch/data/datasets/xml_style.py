"""VOC-XML datasets (counterpart of the JAX package's
`data/datasets/xml_style.py`).

Layout: `<img_prefix>/Annotations/<id>.xml` and `<img_prefix>/JPEGImages/`,
the ids listed one per line in `ann_file`. VOC pixel indices are 1-based;
boxes come out 0-based. Difficult objects, and with `min_size` boxes
narrower or lower than it, go to `bboxes_ignore`. `DADataset` tags every
sample with its domain for the two-stream loader.
"""

from __future__ import annotations

import os.path as osp
import xml.etree.ElementTree as ET
from typing import List

import numpy as np

from ...utils.registry import DATASETS
from .custom import CustomDataset


@DATASETS.register_module()
class XMLDataset(CustomDataset):
    """Pascal-VOC XML annotation dataset."""

    img_subdir = 'JPEGImages'
    ann_subdir = 'Annotations'

    def __init__(self, min_size: int = 0, **kwargs):
        self.min_size = min_size
        super().__init__(**kwargs)

    def load_annotations(self, ann_file: str) -> List[dict]:
        with open(ann_file) as f:
            ids = [line.strip() for line in f if line.strip()]
        infos = []
        for img_id in ids:
            root = ET.parse(osp.join(self.img_prefix, self.ann_subdir,
                                     f'{img_id}.xml')).getroot()
            size = root.find('size')
            width = int(size.find('width').text)
            height = int(size.find('height').text)
            filename = root.find('filename')
            filename = filename.text if filename is not None else \
                f'{img_id}.jpg'
            if osp.dirname(filename) == '':
                filename = osp.join(self.img_subdir, filename)
            bboxes, labels = [], []
            bboxes_ignore, labels_ignore = [], []
            for obj in root.findall('object'):
                name = obj.find('name').text
                if name not in self.cat2label:
                    continue
                label = self.cat2label[name]
                difficult = obj.find('difficult')
                difficult = int(difficult.text) if difficult is not None else 0
                bnd = obj.find('bndbox')
                box = [float(bnd.find(k).text) - 1
                       for k in ('xmin', 'ymin', 'xmax', 'ymax')]
                too_small = self.min_size and (
                    box[2] - box[0] < self.min_size or
                    box[3] - box[1] < self.min_size)
                if difficult or too_small:
                    bboxes_ignore.append(box)
                    labels_ignore.append(label)
                else:
                    bboxes.append(box)
                    labels.append(label)
            ann = dict(
                bboxes=np.asarray(bboxes, np.float32).reshape(-1, 4),
                labels=np.asarray(labels, np.int64),
                bboxes_ignore=np.asarray(bboxes_ignore,
                                         np.float32).reshape(-1, 4),
                labels_ignore=np.asarray(labels_ignore, np.int64),
            )
            infos.append(dict(id=img_id, filename=filename, width=width,
                              height=height, ann=ann))
        return infos


@DATASETS.register_module()
class VOCDataset(XMLDataset):
    """Pascal VOC with the 20 standard classes; a VOC2007 prefix selects
    the 11-point AP."""

    CLASSES = ('aeroplane', 'bicycle', 'bird', 'boat', 'bottle', 'bus', 'car',
               'cat', 'chair', 'cow', 'diningtable', 'dog', 'horse',
               'motorbike', 'person', 'pottedplant', 'sheep', 'sofa', 'train',
               'tvmonitor')

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.year = 2007 if 'VOC2007' in self.img_prefix else 2012


CITYSCAPES_DA_CLASSES = ('person', 'rider', 'car', 'truck', 'bus', 'train',
                         'motorcycle', 'bicycle')


@DATASETS.register_module()
class DADataset(XMLDataset):
    """A domain-tagged VOC-XML dataset (`domain='source'|'target'`), the 8
    Cityscapes DA classes unless `classes=` says otherwise; area AP."""

    CLASSES = CITYSCAPES_DA_CLASSES

    def __init__(self, domain: str = 'source', **kwargs):
        super().__init__(domain=domain, **kwargs)
        self.year = None
