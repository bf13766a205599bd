from .roi_align import (batched_roi_align, batched_roi_align_fpn,
                        batched_roi_align_fpn_plain, batched_roi_align_plain,
                        roi_levels)

__all__ = ['batched_roi_align', 'batched_roi_align_plain',
           'batched_roi_align_fpn', 'batched_roi_align_fpn_plain',
           'roi_levels']
