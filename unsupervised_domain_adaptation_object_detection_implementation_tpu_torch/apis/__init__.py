from .inference import (DetectorBundle, inference_detector, init_detector,
                        prepare_batch)

__all__ = ['DetectorBundle', 'inference_detector', 'init_detector',
           'prepare_batch']
