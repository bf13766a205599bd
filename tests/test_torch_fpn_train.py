"""One whole train step of the tiny FPN detector (the Cityscapes FPN config
with an R18 trunk, a 64-channel neck and 2 classes, smaller proposal and
sample counts) in the port against the JAX package's `make_train_step`,
from the same weights and batch, with the samplers' priorities fixed on
both sides.

Tolerances: per-term losses within 1e-5 relative (the same forward summed
in another order; they agree to a few 1e-7); the momentum (the gradient
plus weight decay after one step) and the updated parameters within 1e-4
of each tensor's scale. The weight seed is one whose step flips no ReLU
unit between the two sides.
"""

import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .test_torch_fpn import FPN_CFG, TINY, regression_init
from .test_torch_train import _close_scaled, _demo_batch, _jax_fixed_samplers
from .torch_port_utils import JAX_PKG, PORT_PKG, fill_variables

ROOT = pathlib.Path(__file__).resolve().parent.parent
OVERRIDES = dict(TINY, **{
    'model.rpn_proposal_cfg': dict(nms_pre=1024, max_per_img=256),
    'model.roi_train_cfg': dict(num_samples=128),
    # one step at step count 0: a warmup lr the update can show
    'lr_config.warmup_ratio': 0.5})

jts = importlib.import_module(f'{JAX_PKG}.apis.train_state')
jbuilder = importlib.import_module(f'{JAX_PKG}.models.builder')
jconfig = importlib.import_module(f'{JAX_PKG}.utils.config')
ttrain = importlib.import_module(f'{PORT_PKG}.apis.train')
tconfig = importlib.import_module(f'{PORT_PKG}.utils.config')
convert = importlib.import_module(f'{PORT_PKG}.utils.convert')


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope='module')
def one_step():
    jcfg = jconfig.Config.fromfile(FPN_CFG)
    jcfg.merge_from_dict(OVERRIDES)
    model = jbuilder.build_detector(jcfg.model)
    cfg = tconfig.Config.fromfile(FPN_CFG)
    cfg.merge_from_dict(OVERRIDES)
    batch = _demo_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    k0 = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: model.init(
        {'params': k0, 'sampler': k0, 'dropout': k0}, jbatch, train=True))
    rs = np.random.RandomState(5)
    variables = regression_init(fill_variables(shapes, rs), rs)

    trainer = ttrain.init_trainer(cfg, variables=variables, device='cpu',
                                  steps_per_epoch=1)
    spec = jts.OptimizerSpec(**trainer.spec._asdict())
    jstate, tx = jts.create_train_state(model, variables, spec,
                                        frozen_stages=1)
    jstep = jax.jit(jts.make_train_step(model, tx))
    rpn_key, roi_key = jax.random.PRNGKey(21), jax.random.PRNGKey(22)
    h, w = batch['image'].shape[1:3]
    anchors = 3 * sum(-(-h // s) * -(-w // s) for s in (4, 8, 16, 32, 64))
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


def test_fpn_train_step_losses_match(one_step):
    jm, tm = one_step['jmetrics'], one_step['tmetrics']
    assert set(tm) == set(jm) == {'loss', 'loss_rpn_cls', 'loss_rpn_bbox',
                                  'loss_cls', 'loss_bbox'}
    for k in jm:
        assert np.isfinite(tm[k]) and tm[k] > 0
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-7)


def _converted(tree, model):
    state, unmapped = convert.from_jax_variables(tree, model)
    assert unmapped == []
    return state


def test_fpn_train_step_state_matches(one_step):
    """Momentum and updated parameters within 1e-4 of each tensor's scale;
    the stem and layer1 bit-identical to the start; the neck, the RPN and
    every other trainable tensor moved."""
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
    assert any(k.startswith('neck.') for k in state.opt_state.momentum)
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
