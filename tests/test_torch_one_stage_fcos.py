"""FCOS against the JAX package (`test_torch_one_stage.one_stage_case`,
whose tolerances these are): the plain R50 config, the center-sampling
GIoU row and its DCN head (each with an R18 trunk and 4 classes). The DCN
case's offset convs keep their 1/sqrt(fan_in) draw, so the deformable
convs of both towers sample between pixels on every level."""

import pytest

from .test_torch_cascade import check_losses, check_update
from .test_torch_one_stage import one_stage_case
from .test_torch_rpn_detectors import check_predict

KEYS = {'loss_cls', 'loss_bbox', 'loss_centerness'}
CENTER = ('configs/fcos/fcos_center-normbbox-centeronreg-giou_r50_caffe_'
          'fpn_gn-head_1x.py')
# (config, weight seed, loss keys)
CASES = {'FCOS': ('configs/fcos/fcos_r50_fpn_1x.py', 0, KEYS),
         'FCOS/center': (CENTER, 0, KEYS),
         'FCOS/dcn': (CENTER.replace('_1x.py', '_dcn_1x.py'), 1, KEYS)}


@pytest.fixture(scope='module', params=sorted(CASES))
def case(request):
    config, seed, _ = CASES[request.param]
    return request.param, one_stage_case(config, seed)


def test_fcos_losses_match(case):
    name, c = case
    check_losses(c, CASES[name][2])


def test_fcos_sgd_update_matches(case):
    name, c = case
    check_update(c)


def test_fcos_predict_matches(case):
    name, c = case
    check_predict(c)
