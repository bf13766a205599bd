"""Grid R-CNN against the JAX package (`configs/grid_rcnn/grid_rcnn_r50_fpn_
gn-head_1x.py` with an R18 trunk, 4 classes and 32 RoIs an image, as
`test_torch_roi_variants.variant_case` builds it): one train step and
`predict` from the same weights; then what Grid R-CNN adds beside the
losses: its box regressor, which no loss reaches, moves by weight decay
alone, as in JAX; its grid targets; and the GRoIE Grid config serves
through the level-assigned extractor, as the JAX package's `predict`
does.

The weight seed is one whose step flips no ReLU unit of the grid head
between the two sides (its 8 convs over 32 RoIs hold some 400k units a
layer; at seed 0 one sits within rounding of zero and moves the momentum
of its conv by 2e-3 of its scale). Tolerances as in
`test_torch_roi_variants.py`.
"""

import importlib

import numpy as np
import pytest
import torch

from .test_torch_cascade import (_converted, check_losses, check_predict,
                                 check_update)
from .test_torch_roi_variants import (ROOT, TINY, jconfig, jbuilder, tconfig,
                                      ttrain, tvariants, variant_case, _t,
                                      CONFIGS)

tfpn = importlib.import_module(
    tvariants.__name__.replace('roi_variants', 'faster_rcnn_fpn'))

GRID_SEED = 3
GRID_KEYS = {'loss_rpn_cls', 'loss_rpn_bbox', 'loss_cls', 'loss_grid'}


@pytest.fixture(scope='module')
def case():
    return variant_case('GridRCNN', GRID_SEED)


def test_grid_losses_match(case):
    check_losses(case, GRID_KEYS)


def test_grid_sgd_update_matches(case):
    check_update(case)


def test_grid_predict_matches(case):
    check_predict(case, False)


def test_grid_regressor_moves_by_weight_decay_alone(case):
    """`bbox_head.fc_reg` gets no gradient (Grid R-CNN trains no box
    regression): on both sides its momentum after the step is the weight
    decay times the weights (exactly, in the port), and the weights move."""
    trainer, state = case['trainer'], case['state']
    wd = trainer.spec.weight_decay
    mom = _converted({'params': case['jstate'].opt_state.momentum},
                     trainer.model)
    start = _converted(case['variables'], trainer.model)
    for k in ('bbox_head.fc_reg.weight', 'bbox_head.fc_reg.bias'):
        want = wd * start[k]
        assert torch.equal(state.opt_state.momentum[k], want), k
        np.testing.assert_allclose(mom[k].numpy(), want.numpy(), rtol=1e-6,
                                   atol=0)
        moved = dict(trainer.model.named_parameters())[k].detach()
        assert not torch.equal(moved, start[k]) or not start[k].any(), k


def test_grid_targets_match_the_jax_heatmaps():
    """The 9-point radius-1 heatmaps in the 2x-expanded RoI frame, for RoIs
    inside, across and past their gt box and one narrower than the grid
    (no `w <= grid_size` gate), against the JAX `_grid_targets`."""
    jcfg = jconfig.Config.fromfile(str(ROOT / CONFIGS['GridRCNN']))
    jcfg.merge_from_dict(TINY)
    jmodel = jbuilder.build_detector(jcfg.model)
    rois = np.array([[[8, 6, 40, 30], [0, 0, 100, 90], [30, 40, 34, 43],
                      [50, 10, 120, 70], [0, 0, 0, 0]]], np.float32)
    gt = np.array([[[10, 8, 36, 28], [5, 5, 60, 80], [31, 40, 36, 44],
                    [60, 20, 100, 60], [0, 0, 0, 0]]], np.float32)
    ref = np.asarray(type(jmodel)._grid_targets(jmodel, rois, gt))
    port = tvariants.GridRCNN.__new__(tvariants.GridRCNN)
    port.grid_size = jmodel.grid_size
    got = port.grid_targets(_t(rois), _t(gt)).numpy()
    assert got.shape == (1, 5, 56, 56, 9)
    np.testing.assert_array_equal(got, ref)


def test_groie_grid_config_serves_through_the_level_assigned_extractor(
        case, monkeypatch):
    """The GRoIE Grid config (`configs/groie/grid_rcnn_r50_fpn_gn-head_
    groie_1x.py`) trains through GRoIE but serves as the plain Grid config
    does: from the same weights its detections equal the plain config's
    bit for bit, and GRoIE's extractor is never called."""
    cfg = tconfig.Config.fromfile(str(ROOT / CONFIGS['GridRCNN/groie']))
    cfg.merge_from_dict(TINY)
    trainer = ttrain.init_trainer(cfg, variables=case['variables'],
                                  device='cpu', steps_per_epoch=1)
    model = trainer.model
    assert model.roi_extractor_type == 'groie'
    calls = []
    orig = tfpn.extract_roi_feats_groie
    monkeypatch.setattr(tfpn, 'extract_roi_feats_groie',
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    rs = np.random.RandomState(3)
    image = rs.standard_normal((2, 96, 160, 3)).astype(np.float32)
    img_shape = np.array([[96, 160], [80, 128]], np.int32)
    got = model.predict(dict(image=_t(image), img_shape=_t(img_shape)))
    assert not calls
    for k, v in case['got'].items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    # and the step does go through GRoIE: the pair once a level, twice
    model.train()
    batch = {k: _t(v) for k, v in case['batch'].items()}
    model.loss(batch, generator=torch.Generator().manual_seed(0))
    assert len(calls) == 2


def test_grid_losses_track_jax_over_four_steps(case):
    """Four steps of each side afresh from the same weights, on one batch
    with the samplers' first draws: every loss term within 1e-3 relative
    of JAX's at each step, and the grid loss falling at each step on both
    sides. The grid head's training (its targets, the GroupNorm over every
    RoI of an image, the BCE) follows JAX's past the one step above. (At
    this tiny size and lr the two sides stay within 1.2e-4 over these four
    steps and part by 3% in `loss_cls` at the fifth.)"""
    steps = case['run_steps'](4)
    for i, (jm, tm) in enumerate(steps):
        assert set(tm) == set(jm) == GRID_KEYS | {'loss'}
        for k, v in jm.items():
            np.testing.assert_allclose(tm[k], v, rtol=1e-3,
                                       err_msg=f'step {i + 1}, {k}')
    grid = [(jm['loss_grid'], tm['loss_grid']) for jm, tm in steps]
    assert all(later[0] < now[0] and later[1] < now[1]
               for now, later in zip(grid, grid[1:])), grid
