from .atss import ATSS, ATSSHead
from .fcos import FCOS, FCOSHead
from .gfl import GFL, GFLHead
from .paa import PAA
from .retinanet import RetinaHead, RetinaNet
from .rpn_detectors import (CascadeRPN, CRPNFasterRCNN, FastRCNN,
                            GAFasterRCNN, GARetinaNet, GARPN,
                            GuidedAnchorHead, RPN)

__all__ = ['ATSS', 'ATSSHead', 'CRPNFasterRCNN', 'CascadeRPN', 'FCOS',
           'FCOSHead', 'FastRCNN', 'GAFasterRCNN', 'GARPN', 'GARetinaNet',
           'GFL', 'GFLHead', 'GuidedAnchorHead', 'PAA', 'RPN', 'RetinaHead',
           'RetinaNet']
