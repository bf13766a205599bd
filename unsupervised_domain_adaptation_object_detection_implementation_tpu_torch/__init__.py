"""PyTorch/CUDA port of the UDAOD detection framework, for one NVIDIA H100.

The JAX package beside it
(`unsupervised_domain_adaptation_object_detection_implementation_tpu`) is
the reference: module paths here mirror it, public functions keep its
layouts and its padded, validity-masked batch contract, and the tests hold
each module against its counterpart there. This package imports torch and
numpy only — nothing of JAX and nothing of the JAX package.

Entry points (`apis.init_detector`, `models.build_detector`) run on CUDA
unless the caller passes `device='cpu'`; without a card they raise.
"""

__version__ = '0.1.0'
