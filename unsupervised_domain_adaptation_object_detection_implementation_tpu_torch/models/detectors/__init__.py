from .atss import ATSS, ATSSHead
from .fcos import FCOS, FCOSHead
from .fovea import FoveaBox, FoveaHead
from .free_anchor import FreeAnchor
from .fsaf import FSAF, FSAFHead
from .gfl import GFL, GFLHead
from .paa import PAA
from .pisa import PISAFasterRCNN, PISAMaskRCNN, PISARetinaNet
from .retinanet import RetinaHead, RetinaNet
from .rpn_detectors import (CascadeRPN, CRPNFasterRCNN, FastRCNN,
                            GAFasterRCNN, GARetinaNet, GARPN,
                            GuidedAnchorHead, RPN)
from .sabl_retina import (SABLBBoxHead, SABLFasterRCNN, SABLRetinaHead,
                          SABLRetinaNet)

__all__ = ['ATSS', 'ATSSHead', 'CRPNFasterRCNN', 'CascadeRPN', 'FCOS',
           'FCOSHead', 'FSAF', 'FSAFHead', 'FastRCNN', 'FoveaBox',
           'FoveaHead', 'FreeAnchor', 'GAFasterRCNN', 'GARPN', 'GARetinaNet',
           'GFL', 'GFLHead', 'GuidedAnchorHead', 'PAA', 'PISAFasterRCNN',
           'PISAMaskRCNN', 'PISARetinaNet', 'RPN', 'RetinaHead', 'RetinaNet',
           'SABLBBoxHead', 'SABLFasterRCNN', 'SABLRetinaHead',
           'SABLRetinaNet']
