from .cross_entropy_loss import (binary_cross_entropy, cross_entropy,
                                 softmax_cross_entropy)
from .focal_loss import sigmoid_focal_loss
from .gan_loss import cycle_consistency_loss, gan_lsgan_loss
from .iou_loss import (BoundedIoULoss, GIoULoss, IoULoss, bounded_iou_loss,
                       ciou_loss, diou_loss, giou_loss, iou_loss)
from .smooth_l1_loss import smooth_l1_loss
from .utils import reduce_loss, weight_reduce_loss

__all__ = ['BoundedIoULoss', 'GIoULoss', 'IoULoss', 'binary_cross_entropy',
           'bounded_iou_loss', 'ciou_loss', 'cross_entropy',
           'cycle_consistency_loss', 'diou_loss', 'gan_lsgan_loss',
           'giou_loss', 'iou_loss', 'reduce_loss', 'sigmoid_focal_loss',
           'smooth_l1_loss', 'softmax_cross_entropy', 'weight_reduce_loss']
