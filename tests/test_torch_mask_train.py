"""One whole train step of the tiny Mask R-CNN detectors in the port against
the JAX package's `make_train_step`, from the same weights and batch, with
the samplers' priorities fixed on both sides: `MaskRCNN` (the Cityscapes
mask config with an R18 trunk, a 64-channel neck and 2 classes) and
`MaskRCNNC4` (the C4 config with an R18 trunk and 2 classes), on the
128x192 batch of `test_torch_train.py` plus seeded box-frame ellipse
rasters of 28x28.

Tolerances: per-term losses within 1e-5 relative (the same forward summed
in another order); the momentum (the gradient plus weight decay after one
step) and the updated parameters within 1e-4 of each tensor's scale. The
JAX steps compile with plain `jax.jit`: unlike the DAF step's global heads
(`test_torch_train.py`), they stay finite with XLA:CPU's `algsimp` pass.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .test_torch_fpn import TINY, regression_init
from .test_torch_mask import C4_CFG, C4_TINY, MASK_CFG
from .test_torch_train import _close_scaled, _demo_batch, _jax_fixed_samplers
from .torch_port_utils import JAX_PKG, PORT_PKG, fill_variables

STEP = {
    # one step at step count 0: a warmup lr the update can show
    'lr_config.warmup_ratio': 0.5,
    'model.rpn_proposal_cfg': dict(nms_pre=1024, max_per_img=256),
    'model.roi_train_cfg': dict(num_samples=128)}
# (config, overrides, weight seed, anchor strides). The seeds are ones whose
# step flips no ReLU unit between the two sides; C4's res5 weight gradients
# sum 2 x 128 RoIs x 49 positions each and agree to 8e-5 of scale at seed 3
CASES = {'fpn': (MASK_CFG, dict(TINY, **STEP), 5, (4, 8, 16, 32, 64)),
         'c4': (C4_CFG, dict(C4_TINY, **STEP), 3, (16,))}

jts = importlib.import_module(f'{JAX_PKG}.apis.train_state')
jbuilder = importlib.import_module(f'{JAX_PKG}.models.builder')
jconfig = importlib.import_module(f'{JAX_PKG}.utils.config')
ttrain = importlib.import_module(f'{PORT_PKG}.apis.train')
tconfig = importlib.import_module(f'{PORT_PKG}.utils.config')
tprofile = importlib.import_module(f'{PORT_PKG}.tools.profile_train')
convert = importlib.import_module(f'{PORT_PKG}.utils.convert')


def _t(x):
    return torch.from_numpy(np.array(x))


def _step(name):
    path, overrides, seed, strides = CASES[name]
    jcfg = jconfig.Config.fromfile(path)
    jcfg.merge_from_dict(overrides)
    model = jbuilder.build_detector(jcfg.model)
    cfg = tconfig.Config.fromfile(path)
    cfg.merge_from_dict(overrides)
    batch = _demo_batch()
    batch['gt_masks'] = tprofile.ellipse_masks(np.random.RandomState(6),
                                               batch['gt_valid'].shape, 28)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    k0 = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: model.init(
        {'params': k0, 'sampler': k0, 'dropout': k0}, jbatch, train=True))
    rs = np.random.RandomState(seed)
    variables = regression_init(fill_variables(shapes, rs), rs)

    trainer = ttrain.init_trainer(cfg, variables=variables, device='cpu',
                                  steps_per_epoch=1)
    spec = jts.OptimizerSpec(**trainer.spec._asdict())
    jstate, tx = jts.create_train_state(model, variables, spec,
                                        frozen_stages=1)
    jstep = jax.jit(jts.make_train_step(model, tx))
    rpn_key, roi_key = jax.random.PRNGKey(21), jax.random.PRNGKey(22)
    h, w = batch['image'].shape[1:3]
    per_loc = 3 if name == 'fpn' else 15
    anchors = per_loc * sum(-(-h // s) * -(-w // s) for s in strides)
    cands = batch['gt_bboxes'].shape[1] + model.rpn_proposal_cfg.max_per_img
    pri = dict(rpn=_t(jax.random.uniform(rpn_key, (anchors,))).expand(2, -1),
               rcnn=_t(jax.random.uniform(roi_key, (cands,))).expand(2, -1))
    with _jax_fixed_samplers(rpn_key, roi_key):
        jstate, jm = jstep(jstate, jbatch, jax.random.PRNGKey(3))
    state, tm = trainer.step(trainer.state, {k: _t(v) for k, v in
                                             batch.items()},
                             sampler_priorities=pri)
    return dict(jstate=jax.device_get(jstate),
                jmetrics=jax.tree_util.tree_map(np.asarray, jm),
                tmetrics={k: v.numpy() for k, v in tm.items()},
                trainer=trainer, state=state, variables=variables)


@pytest.fixture(scope='module', params=sorted(CASES))
def one_step(request):
    return _step(request.param)


def test_mask_train_step_losses_match(one_step):
    jm, tm = one_step['jmetrics'], one_step['tmetrics']
    assert set(tm) == set(jm) == {'loss', 'loss_rpn_cls', 'loss_rpn_bbox',
                                  'loss_cls', 'loss_bbox', 'loss_mask'}
    for k in jm:
        assert np.isfinite(tm[k]) and tm[k] > 0
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-7)


def _converted(tree, model):
    state, unmapped = convert.from_jax_variables(tree, model)
    assert unmapped == []
    return state


def test_mask_train_step_state_matches(one_step):
    """Momentum and updated parameters within 1e-4 of each tensor's scale;
    the stem and layer1 bit-identical to the start; the mask head and every
    other trainable tensor moved."""
    trainer, jstate, state = (one_step['trainer'], one_step['jstate'],
                              one_step['state'])
    model = trainer.model
    assert state.step == 1 and state.ema_params is None
    mom = _converted({'params': jstate.opt_state.momentum}, model)
    frozen = ('backbone.conv1', 'backbone.bn1', 'backbone.layer1.')
    for k, m in mom.items():        # the JAX state keeps frozen ones at 0
        if k.startswith(frozen):
            assert k not in state.opt_state.momentum and not m.any(), k
        else:
            _close_scaled(state.opt_state.momentum[k].numpy(), m.numpy(),
                          1e-4, floor=1e-3)
    assert any(k.startswith('mask_head.') for k in state.opt_state.momentum)
    ref = _converted({'params': jstate.params,
                      'batch_stats': jstate.batch_stats}, model)
    start = _converted(one_step['variables'], model)
    params = dict(model.named_parameters())
    for k, v in model.state_dict().items():
        _close_scaled(v.numpy(), ref[k].numpy())
        if k.startswith(frozen) or k not in params:
            np.testing.assert_array_equal(v.numpy(), start[k].numpy())
        else:
            assert not np.array_equal(v.numpy(), start[k].numpy()), k
