"""`predict` and two train steps of the tiny SWDA, DeepAlign and
Tri-attention detectors against the JAX package's `make_train_step`, as
`test_torch_da_variants.py` runs them for DAF-original and MAF (split off
to keep each file near two minutes on one worker). Tolerances: losses
within 1e-4 relative, parameters, batch statistics, EMA and momentum
within 1e-4 of scale."""

import pytest

from .test_torch_da_variants import check_variant, variant_run


@pytest.mark.parametrize('det_type', ['FasterRCNN_SWDA', 'DAFasterRCNN_Deep',
                                      'DAFasterRCNN_Tri'])
def test_variant_predict_and_train_steps_match(det_type):
    check_variant(variant_run(det_type))
