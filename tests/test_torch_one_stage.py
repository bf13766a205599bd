"""The one-stage core against the JAX package, whole detectors: RetinaNet
with the focal loss and with GHM-C (its R50 configs with an R18 trunk and
4 classes), from the same weights: `predict` on two images of 96x160 and
one train step on two images of 128x192 (gts of 12–100 px spread over the
canvas, 4 and 3 of 6 valid).

`one_stage_case` is shared with `test_torch_one_stage_{fcos,atss,gfl}.py`.
Tolerances: each loss term within 1e-4 relative; the momentum after the
step within 1e-4 of the whole update's scale and 5e-3 of each tensor's
(`test_torch_cascade.check_update`); `predict`'s detections within 1e-3,
labels and validity identical (`test_torch_rpn_detectors.check_predict`).
The port's step runs at `PARITY_THREADS`. One JAX compile of the train
step (the loss and its gradient) and one of `predict` a detector.
"""

import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from .test_torch_cascade import _t, check_losses, check_update
from .test_torch_rpn_detectors import check_predict
from .torch_port_utils import (JAX_PKG, PARITY_THREADS, PORT_PKG,
                               fill_variables, torch_threads)

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the tiny detectors: an R18 trunk, 4 classes, a few hundred candidates
# to serve (fewer JAX NMS tiles to compile), a warmup lr the one step's
# update can show
TINY = {'model.backbone_depth': 18, 'model.num_classes': 4,
        'model.test_cfg': dict(nms_pre=256, max_per_img=50),
        'lr_config.warmup_ratio': 0.5}

jts = importlib.import_module(f'{JAX_PKG}.apis.train_state')
jbuilder = importlib.import_module(f'{JAX_PKG}.models.builder')
jconfig = importlib.import_module(f'{JAX_PKG}.utils.config')
ttrain = importlib.import_module(f'{PORT_PKG}.apis.train')
tconfig = importlib.import_module(f'{PORT_PKG}.utils.config')


def train_batch(b=2, h=128, w=192, g=6, seed=4):
    """Two images with `g` gt boxes of 12–100 px anywhere on the canvas
    (4 and 3 valid) and labels among 4 classes."""
    rs = np.random.RandomState(seed)
    wh = rs.uniform(12, 100, (b, g, 2))
    xy = rs.uniform(0, 1, (b, g, 2)) * ([w, h] - wh)
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    return dict(image=rs.standard_normal((b, h, w, 3)).astype(np.float32),
                img_shape=np.array([[h, w]] * b, np.int32),
                gt_bboxes=boxes,
                gt_labels=rs.randint(0, 4, (b, g)).astype(np.int32),
                gt_valid=np.arange(g)[None, :] < np.array([[4], [3]])[:b])


def one_stage_case(config, seed, extra=None, init=None):
    """One train step and `predict` of the tiny detector of `config` on
    both sides from the same weights (`fill_variables` at `seed`, then
    `init(variables, rs)` when given)."""
    path = str(ROOT / config)
    options = dict(TINY, **(extra or {}))
    jcfg = jconfig.Config.fromfile(path)
    jcfg.merge_from_dict(options)
    model = jbuilder.build_detector(jcfg.model)
    batch = train_batch()
    rs = np.random.RandomState(5)
    test = dict(image=rs.standard_normal((2, 96, 160, 3)).astype(np.float32),
                img_shape=np.array([[96, 160], [80, 128]], np.int32))
    k0 = jax.random.PRNGKey(0)
    dummy = {k: jnp.asarray(v[:1]) for k, v in test.items()}
    shapes = jax.eval_shape(lambda: model.init(
        {'params': k0, 'sampler': k0, 'dropout': k0}, dummy, train=False))
    rs = np.random.RandomState(seed)
    variables = fill_variables(shapes, rs)
    if init is not None:
        variables = init(variables, rs)

    cfg = tconfig.Config.fromfile(path)
    cfg.merge_from_dict(options)
    trainer = ttrain.init_trainer(cfg, variables=variables, device='cpu',
                                  steps_per_epoch=1)
    ref = jax.jit(lambda v, bt: model.apply(v, bt, train=False))(
        variables, {k: jnp.asarray(v) for k, v in test.items()})
    got = trainer.model.predict({k: _t(v) for k, v in test.items()})

    spec = jts.OptimizerSpec(**trainer.spec._asdict())
    jstate, tx = jts.create_train_state(model, variables, spec,
                                        frozen_stages=1)
    jstep = jax.jit(jts.make_train_step(model, tx))
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                       jax.random.PRNGKey(3))
    with torch_threads(PARITY_THREADS):
        state, tm = trainer.step(trainer.state,
                                 {k: _t(v) for k, v in batch.items()})
    return dict(jstate=jax.device_get(jstate),
                jmetrics=jax.tree_util.tree_map(np.asarray, jm),
                tmetrics={k: v.numpy() for k, v in tm.items()},
                trainer=trainer, state=state, variables=variables,
                batch=batch, ref=jax.tree_util.tree_map(np.asarray, ref),
                got={k: v.numpy() for k, v in got.items()})


RETINA = 'configs/retinanet/retinanet_r50_fpn_1x.py'
GHM = 'configs/ghm/retinanet_ghm_r50_fpn_1x.py'
BOX = {'loss_cls', 'loss_bbox'}
# (config, weight seed, loss keys)
CASES = {'RetinaNet': (RETINA, 0, BOX), 'RetinaNet/ghm': (GHM, 2, BOX)}


@pytest.fixture(scope='module', params=sorted(CASES))
def case(request):
    config, seed, _ = CASES[request.param]
    return request.param, one_stage_case(config, seed)


def test_retinanet_losses_match(case):
    name, c = case
    check_losses(c, CASES[name][2])


def test_retinanet_sgd_update_matches(case):
    name, c = case
    check_update(c)


def test_retinanet_predict_matches(case):
    name, c = case
    check_predict(c)
