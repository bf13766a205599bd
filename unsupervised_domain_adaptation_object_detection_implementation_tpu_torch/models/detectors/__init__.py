from .rpn_detectors import (CascadeRPN, CRPNFasterRCNN, FastRCNN,
                            GAFasterRCNN, GARetinaNet, GARPN,
                            GuidedAnchorHead, RPN)

__all__ = ['CRPNFasterRCNN', 'CascadeRPN', 'FastRCNN', 'GAFasterRCNN',
           'GARPN', 'GARetinaNet', 'GuidedAnchorHead', 'RPN']
