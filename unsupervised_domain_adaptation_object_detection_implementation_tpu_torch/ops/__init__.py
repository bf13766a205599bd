from .deform_conv import batched_deform_conv2d, deform_conv2d
from .roi_align import (batched_roi_align, batched_roi_align_fpn,
                        batched_roi_align_fpn_plain, batched_roi_align_plain,
                        roi_levels)

__all__ = ['batched_deform_conv2d', 'batched_roi_align',
           'batched_roi_align_plain', 'batched_roi_align_fpn',
           'batched_roi_align_fpn_plain', 'deform_conv2d', 'roi_levels']
