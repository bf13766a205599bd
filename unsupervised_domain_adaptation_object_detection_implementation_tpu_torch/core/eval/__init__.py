from .mean_ap import average_precision, eval_map, eval_recalls, tpfp_default

__all__ = ['average_precision', 'eval_map', 'eval_recalls', 'tpfp_default']
