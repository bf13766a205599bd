"""ATSS and PAA against the JAX package (`test_torch_one_stage.
one_stage_case`, whose tolerances these are; their R50 configs with an
R18 trunk and 4 classes). The weight seeds are ones whose step puts no
anchor within rounding of the ATSS IoU threshold, and no PAA candidate
within float error of a responsibility of 0.5, on one side and past it
on the other."""

import pytest

from .test_torch_cascade import check_losses, check_update
from .test_torch_one_stage import one_stage_case
from .test_torch_rpn_detectors import check_predict

# (config, weight seed, loss keys)
CASES = {'ATSS': ('configs/atss/atss_r50_fpn_1x.py', 0,
                  {'loss_cls', 'loss_bbox', 'loss_centerness'}),
         'PAA': ('configs/paa/paa_r50_fpn_1x.py', 0,
                 {'loss_cls', 'loss_bbox', 'loss_iou'})}


@pytest.fixture(scope='module', params=sorted(CASES))
def case(request):
    config, seed, _ = CASES[request.param]
    return request.param, one_stage_case(config, seed)


def test_atss_family_losses_match(case):
    name, c = case
    check_losses(c, CASES[name][2])


def test_atss_family_sgd_update_matches(case):
    name, c = case
    check_update(c)


def test_atss_family_predict_matches(case):
    name, c = case
    check_predict(c)
