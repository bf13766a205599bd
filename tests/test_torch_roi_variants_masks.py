"""Mask Scoring R-CNN against the JAX package (`configs/ms_rcnn/ms_rcnn_
r50_fpn_1x.py` with an R18 trunk, 4 classes and 32 RoIs an image, as
`test_torch_roi_variants.variant_case` builds it, with seeded 28x28
box-frame rasters): one train step and `predict` (masks and the rescored
detections) from the same weights; then the gradient that its IoU loss
sends into the mask head. Tolerances as in `test_torch_roi_variants.py`.
"""

import pytest
import torch

from .test_torch_cascade import (check_losses, check_predict, check_update)
from .test_torch_roi_variants import BOX_KEYS, variant_case, _t

MASK_KEYS = BOX_KEYS | {'loss_mask', 'loss_mask_iou'}


@pytest.fixture(scope='module')
def case():
    return variant_case('MaskScoringRCNN', 0)


def test_mask_scoring_losses_match(case):
    check_losses(case, MASK_KEYS)


def test_mask_scoring_sgd_update_matches(case):
    check_update(case)


def test_mask_scoring_predict_matches(case):
    check_predict(case, True)


def mask_head_gradients(c, key):
    """The gradient of loss term `key` alone, from one more loss on the
    case's batch, into each weight of the mask head."""
    model = c['trainer'].model
    model.train()
    batch = {k: _t(v) for k, v in c['batch'].items()}
    losses = model.loss(batch, generator=torch.Generator().manual_seed(0))
    heads = [p for n, p in model.named_parameters()
             if n.startswith('mask_head.') and n.endswith('weight')]
    assert len(heads) == 6
    return torch.autograd.grad(losses[key], heads)


def test_mask_iou_loss_trains_the_mask_head(case):
    """The IoU head reads the sigmoid of the selected mask logits without a
    stop-gradient, as in JAX: `loss_mask_iou` alone sends a gradient into
    every layer of the mask head (and the step's momentum there matches
    JAX's, above)."""
    assert all(float(g.abs().max()) > 0
               for g in mask_head_gradients(case, 'loss_mask_iou'))
