from .cross_entropy_loss import (binary_cross_entropy, cross_entropy,
                                 softmax_cross_entropy)
from .focal_loss import sigmoid_focal_loss
from .smooth_l1_loss import smooth_l1_loss
from .utils import reduce_loss, weight_reduce_loss

__all__ = ['binary_cross_entropy', 'cross_entropy', 'reduce_loss',
           'sigmoid_focal_loss', 'smooth_l1_loss', 'softmax_cross_entropy',
           'weight_reduce_loss']
