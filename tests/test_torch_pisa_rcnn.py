"""PISA Faster R-CNN and PISA Mask R-CNN against the JAX package
(`configs/pisa/pisa_{faster,mask}_rcnn_r50_fpn_1x.py` with an R18 trunk,
4 classes, 32 RoIs and 256 proposals; 12 proposals an image served, so
that padded rows reach the mask branch), through
`test_torch_sabl_rcnn.roi_case`, whose tolerances these are; the mask
case on box-frame rasters of 28x28.
"""

import pytest

from .test_torch_cascade import check_losses, check_predict, check_update
from .test_torch_sabl_rcnn import RPN_KEYS, roi_case

TINY = {'model.backbone_depth': 18, 'model.num_classes': 4,
        'model.roi_train_cfg': dict(num_samples=32),
        'model.rpn_proposal_cfg': dict(nms_pre=1024, max_per_img=256),
        'model.rpn_test_cfg': dict(max_per_img=12),
        'model.roi_test_cfg': dict(max_per_img=50),
        'lr_config.warmup_ratio': 0.5}
BOX_KEYS = RPN_KEYS | {'loss_cls', 'loss_bbox'}
# (config, weight seed, loss keys, mask size)
CASES = {
    'PISAFasterRCNN': ('configs/pisa/pisa_faster_rcnn_r50_fpn_1x.py', 0,
                       BOX_KEYS, None),
    'PISAMaskRCNN': ('configs/pisa/pisa_mask_rcnn_r50_fpn_1x.py', 0,
                     BOX_KEYS | {'loss_mask'}, 28)}


@pytest.fixture(scope='module', params=sorted(CASES))
def case(request):
    config, seed, _, mask = CASES[request.param]
    return request.param, roi_case(config, seed, TINY, 256, 32,
                                   mask_size=mask)


def test_pisa_rcnn_losses_match(case):
    name, c = case
    check_losses(c, CASES[name][2])


def test_pisa_rcnn_sgd_update_matches(case):
    name, c = case
    check_update(c)


def test_pisa_rcnn_predict_matches(case):
    name, c = case
    check_predict(c, with_masks=CASES[name][3] is not None)
