from .roi_align import batched_roi_align, batched_roi_align_plain

__all__ = ['batched_roi_align', 'batched_roi_align_plain']
