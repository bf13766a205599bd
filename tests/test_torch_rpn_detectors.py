"""The proposal-network family against the JAX package: the standalone RPN
(FPN and C4) and Fast R-CNN on given proposals (their R50 configs with an
R18 trunk and, for Fast R-CNN, 4 classes and 32 RoIs an image), from the
same weights: one train step on an image of 128x192 with the samplers'
priorities fixed on both sides, and `predict` on two images.

`rpn_case` is shared with `test_torch_ga.py` (Guided Anchoring) and
`test_torch_crpn.py` (Cascade RPN). Tolerances: each loss term within 1e-4
relative; the momentum after the step within 1e-4 of the whole update's
scale and 5e-3 of each tensor's (`test_torch_cascade.check_update`);
`predict`'s detections within 1e-3 with labels and validity identical.
The port's step runs at `PARITY_THREADS`. One JAX compile of the train
step and one of `predict` a model.
"""

import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from .test_torch_cascade import _t, check_losses, check_update
from .test_torch_train import _demo_batch, _jax_fixed_samplers
from .torch_port_utils import (JAX_PKG, PARITY_THREADS, PORT_PKG,
                               fill_variables, torch_threads)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = {
    'RPN': 'configs/rpn/rpn_r50_fpn_1x.py',
    'RPN/c4': 'configs/rpn/rpn_r50_caffe_c4_1x.py',
    'FastRCNN': 'configs/fast_rcnn/fast_rcnn_r50_fpn_1x.py',
    'GARPN': 'configs/guided_anchoring/ga_rpn_r50_fpn_1x.py',
    'GARetinaNet': 'configs/guided_anchoring/ga_retinanet_r50_fpn_1x.py',
    'GAFasterRCNN': 'configs/guided_anchoring/ga_faster_r50_fpn_1x.py',
    'CascadeRPN': 'configs/cascade_rpn/crpn_r50_caffe_fpn_1x.py',
    'CRPNFasterRCNN':
        'configs/cascade_rpn/crpn_faster_rcnn_r50_caffe_fpn_1x.py'}
NUM_SAMPLES = 32
PROPOSALS = 64          # proposals an image to train the RoI heads on
# the tiny detectors: an R18 trunk, the proposal paths cut to a few
# hundred candidates (fewer JAX NMS tiles to compile), 4 classes where the
# detector has classes; a warmup lr the one step's update can show
TINY = {'model.backbone_depth': 18, 'lr_config.warmup_ratio': 0.5}
CLASSES = {'model.num_classes': 4,
           'model.roi_train_cfg': dict(num_samples=NUM_SAMPLES),
           'model.roi_test_cfg': dict(max_per_img=50)}
OPTIONS = {
    'RPN': {'model.test_cfg': dict(nms_pre=512, max_per_img=100)},
    'RPN/c4': {'model.test_cfg': dict(nms_pre=512, max_per_img=100)},
    'FastRCNN': CLASSES,
    'GARPN': {'model.test_cfg': dict(nms_pre=512, max_per_img=100)},
    'GARetinaNet': {'model.num_classes': 4,
                    'model.test_cfg': dict(nms_pre=256, max_per_img=50)},
    'GAFasterRCNN': dict(CLASSES, **{
        'model.rpn_proposal_cfg': dict(nms_pre=512, max_per_img=PROPOSALS),
        'model.test_cfg': dict(nms_pre=512, max_per_img=24)}),
    'CascadeRPN': {'model.test_cfg': dict(nms_pre=512, max_per_img=100)},
    'CRPNFasterRCNN': dict(CLASSES, **{
        'model.rpn_proposal_cfg': dict(nms_pre=512, max_per_img=PROPOSALS),
        'model.test_cfg': dict(nms_pre=512, max_per_img=24)})}
STRIDES = (4, 8, 16, 32, 64)
# the detectors whose RoI sampler draws over the gt boxes and P proposals
RCNN = {'FastRCNN', 'GAFasterRCNN', 'CRPNFasterRCNN'}

jts = importlib.import_module(f'{JAX_PKG}.apis.train_state')
jbuilder = importlib.import_module(f'{JAX_PKG}.models.builder')
jconfig = importlib.import_module(f'{JAX_PKG}.utils.config')
ttrain = importlib.import_module(f'{PORT_PKG}.apis.train')
tconfig = importlib.import_module(f'{PORT_PKG}.utils.config')


def rpn_anchor_count(name, h, w):
    """The anchors the RPN sampler draws over on an (h, w) image."""
    if name == 'RPN/c4':
        return 15 * -(-h // 16) * -(-w // 16)
    return 3 * sum(-(-h // s) * -(-w // s) for s in STRIDES)


def fixed_proposals(rs, b, p, h, w):
    """(b, p, 4) proposals over an (h, w) image and their validity (the
    last quarter of each row padded), for Fast R-CNN."""
    xy = rs.uniform(0, 0.8, (b, p, 2)) * [w, h]
    wh = rs.uniform(0.05, 0.5, (b, p, 2)) * [w, h]
    boxes = np.concatenate([xy, np.minimum(xy + wh, [w, h])], -1)
    valid = np.arange(p)[None, :] < np.array([[3 * p // 4], [p // 2]])[:b]
    return (boxes * valid[..., None]).astype(np.float32), valid


def adaptive_init(variables, rs):
    """The heads at the scales of their own inits, where `fill_variables`
    leaves logits and deltas of order ten on the tiny trunk's features:
    the adaptive convs' HWIO kernels at flax's `he_normal` scale (a raw
    parameter gets 0.1 otherwise), the location, shape and class convs and
    the regressors at std 0.01 (the box head's 0.001, as
    `test_torch_cascade.regression_init`), the GA location logit's bias at
    the JAX init's -4.595 (so the location filter drops some anchors and
    keeps others; the class logits keep a bias near 0, so GA-RetinaNet's
    random-weight scores pass its 0.05 threshold). The offset convs keep their 1/sqrt(fan_in) draw, so the
    deformable sampling lands between pixels."""
    def walk(tree):
        for k, v in tree.items():
            if k in ('adapt_conv_w', 's2_adapt_w'):
                fan_in = int(np.prod(v.shape[:-1]))
                tree[k] = (rs.standard_normal(v.shape)
                           * np.sqrt(2.0 / fan_in)).astype(np.float32)
            elif k in SMALL_HEADS:
                v['kernel'] = (rs.standard_normal(v['kernel'].shape)
                               * SMALL_HEADS[k]).astype(np.float32)
                if k == 'conv_loc':
                    v['bias'] = np.full(v['bias'].shape, -4.595, np.float32)
            elif hasattr(v, 'items'):
                walk(v)
    walk(variables['params'])
    return variables


SMALL_HEADS = {'rpn_reg': 0.01, 'fc_reg': 0.001, 'conv_reg': 0.01,
               'conv_loc': 0.01, 'conv_shape': 0.01, 'conv_cls': 0.01,
               's1_reg': 0.01, 's2_reg': 0.01, 's2_cls': 0.01}


def sampler_priorities(name, batch, rpn_key, roi_key):
    """The port's priorities equal to what the JAX samplers draw from the
    fixed keys: the RPN's over its anchors, the RoI sampler's over the gt
    boxes and the proposals."""
    b, h, w = batch['image'].shape[:3]
    g = batch['gt_bboxes'].shape[1]
    pri = {}
    if name.startswith('RPN'):
        pri['rpn'] = jax.random.uniform(rpn_key,
                                        (rpn_anchor_count(name, h, w),))
    if name in RCNN:
        p = batch['proposals'].shape[1] if name == 'FastRCNN' else PROPOSALS
        pri['rcnn'] = jax.random.uniform(roi_key, (g + p,))
    return {k: _t(v).expand(b, -1) for k, v in pri.items()}


def rpn_case(name, seed, extra=None):
    """One train step and `predict` of the tiny detector of CONFIGS[name]
    on both sides from the same weights."""
    path = str(ROOT / CONFIGS[name])
    options = dict(TINY, **OPTIONS[name], **(extra or {}))
    jcfg = jconfig.Config.fromfile(path)
    jcfg.merge_from_dict(options)
    model = jbuilder.build_detector(jcfg.model)
    batch = {k: v[:1] for k, v in _demo_batch().items()}
    batch['gt_labels'] = np.random.RandomState(9).randint(
        0, 4, batch['gt_labels'].shape).astype(np.int32)
    rs = np.random.RandomState(5)
    test = dict(image=rs.standard_normal((2, 96, 160, 3)).astype(np.float32),
                img_shape=np.array([[96, 160], [80, 128]], np.int32))
    if name == 'FastRCNN':
        batch['proposals'], batch['proposals_valid'] = fixed_proposals(
            rs, 1, 48, 128, 192)
        test['proposals'], test['proposals_valid'] = fixed_proposals(
            rs, 2, 40, 96, 160)
    k0 = jax.random.PRNGKey(0)
    dummy = {k: jnp.asarray(v[:1]) for k, v in test.items()}
    shapes = jax.eval_shape(lambda: model.init(
        {'params': k0, 'sampler': k0, 'dropout': k0}, dummy, train=False))
    rs = np.random.RandomState(seed)
    variables = adaptive_init(fill_variables(shapes, rs), rs)

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
    rpn_key, roi_key = jax.random.PRNGKey(21), jax.random.PRNGKey(22)
    with _jax_fixed_samplers(rpn_key, roi_key):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()},
                           jax.random.PRNGKey(3))
    with torch_threads(PARITY_THREADS):
        state, tm = trainer.step(
            trainer.state, {k: _t(v) for k, v in batch.items()},
            sampler_priorities=sampler_priorities(name, batch, rpn_key,
                                                  roi_key))
    return dict(jstate=jax.device_get(jstate),
                jmetrics=jax.tree_util.tree_map(np.asarray, jm),
                tmetrics={k: v.numpy() for k, v in tm.items()},
                trainer=trainer, state=state, variables=variables,
                batch=batch, ref=jax.tree_util.tree_map(np.asarray, ref),
                got={k: v.numpy() for k, v in got.items()})


def check_predict(case, min_valid=20):
    """Detections within 1e-3, labels and validity identical, some rows
    valid (and, past them, zero)."""
    ref, got = case['ref'], case['got']
    assert set(got) == set(ref) == {'dets', 'labels', 'valid'}
    valid = ref['valid']
    assert valid.sum() >= min_valid
    np.testing.assert_array_equal(got['valid'], valid)
    np.testing.assert_array_equal(got['labels'], ref['labels'])
    np.testing.assert_allclose(got['dets'], ref['dets'], atol=1e-3)
    assert not got['dets'][~valid].any()


RPN_KEYS = {'loss_rpn_cls', 'loss_rpn_bbox'}
# (weight seed, loss keys)
CASES = {'RPN': (0, RPN_KEYS),
         'RPN/c4': (2, RPN_KEYS),
         'FastRCNN': (0, {'loss_cls', 'loss_bbox'})}


@pytest.fixture(scope='module', params=sorted(CASES))
def case(request):
    return request.param, rpn_case(request.param, CASES[request.param][0])


def test_proposal_detector_losses_match(case):
    name, c = case
    check_losses(c, CASES[name][1])


def test_proposal_detector_sgd_update_matches(case):
    name, c = case
    check_update(c)


def test_proposal_detector_predict_matches(case):
    name, c = case
    check_predict(c)
