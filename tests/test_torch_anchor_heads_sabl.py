"""SABL-RetinaNet against the JAX package, the whole detector (its R50
config with an R18 trunk and 4 classes: square anchors, bucket logits and
offsets, the rescored serving path), from the same weights: `predict` on two
images of 96x160 and one train step on two images of 128x192
(`test_torch_one_stage.one_stage_case`, whose tolerances these are: each
loss term within 1e-4 relative, the momentum within 1e-4 of the whole
update's scale and 5e-3 of each tensor's, the detections within 1e-3).
One JAX compile of the train step and one of `predict`.
"""

import pytest

from .test_torch_cascade import check_losses, check_update
from .test_torch_one_stage import one_stage_case
from .test_torch_rpn_detectors import check_predict

# (config, weight seed, loss keys)
CASES = {'SABLRetinaNet': ('configs/sabl/sabl_retinanet_r50_fpn_1x.py', 0,
                          {'loss_cls', 'loss_bbox_cls', 'loss_bbox_reg'})}


@pytest.fixture(scope='module', params=sorted(CASES))
def case(request):
    config, seed, _ = CASES[request.param]
    return request.param, one_stage_case(config, seed)


def test_sabl_retina_losses_match(case):
    name, c = case
    check_losses(c, CASES[name][2])


def test_sabl_retina_sgd_update_matches(case):
    name, c = case
    check_update(c)


def test_sabl_retina_predict_matches(case):
    name, c = case
    check_predict(c)
