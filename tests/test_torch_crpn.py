"""Cascade RPN against the JAX package: `CascadeRPN` and `CRPNFasterRCNN`
(their R50 configs with an R18 trunk; 4 classes and 32 RoIs an image for
the two-stage one), from the same weights: one train step on an image of
128x192 (the RoI sampler's priorities fixed on both sides), and `predict`
on two images (`test_torch_rpn_detectors.rpn_case`, whose tolerances these
are). Stage 1 regresses at std 0.01, so the refined anchors stay near the
square ones; the stage-2 offset conv at 1/sqrt(fan_in), so the adaptive
conv samples between pixels.

The weight seeds are ones whose step assigns no refined anchor within
rounding of an IoU threshold on one side and past it on the other."""

import pytest

from .test_torch_cascade import check_losses, check_update
from .test_torch_rpn_detectors import check_predict, rpn_case

CRPN_KEYS = {'loss_rpn_reg_s1', 'loss_rpn_cls', 'loss_rpn_reg_s2'}
# (weight seed, loss keys)
CASES = {'CascadeRPN': (0, CRPN_KEYS),
         'CRPNFasterRCNN': (0, CRPN_KEYS | {'loss_cls', 'loss_bbox'})}


@pytest.fixture(scope='module', params=sorted(CASES))
def case(request):
    return request.param, rpn_case(request.param, CASES[request.param][0])


def test_crpn_losses_match(case):
    name, c = case
    check_losses(c, CASES[name][1])


def test_crpn_sgd_update_matches(case):
    name, c = case
    check_update(c)


def test_crpn_predict_matches(case):
    name, c = case
    check_predict(c)
