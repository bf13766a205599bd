from .two_stream import GroupBatchSampler, TwoStreamBatchSampler

__all__ = ['GroupBatchSampler', 'TwoStreamBatchSampler']
