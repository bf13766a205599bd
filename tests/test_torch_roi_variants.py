"""The two-stage RoI-head variants against the JAX package: Double-Head
R-CNN and Dynamic R-CNN (their COCO configs with an R18 trunk, 4 classes
and 32 RoIs an image; the heads at their published widths), from the same
weights: one train step on an image of 128x192 with both samplers'
priorities fixed on both sides, and `predict` on two images.

`variant_case` is shared with `test_torch_roi_variants_grid.py` (Grid
R-CNN) and `test_torch_roi_variants_masks.py` (Mask Scoring R-CNN and
PointRend). Tolerances: each loss term within 1e-4
relative; the momentum after the step within 1e-4 of the whole update's
scale and 5e-3 of each tensor's (`test_torch_cascade.check_update`);
`predict`'s detections within 1e-3 with labels and validity identical,
masks within 1e-4. The port's step runs at `PARITY_THREADS`. One JAX
compile of the train step and one of `predict` a model.
"""

import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from .test_torch_cascade import (_t, check_losses, check_predict,
                                 check_update, regression_init)
from .test_torch_train import _demo_batch, _jax_fixed_samplers
from .torch_port_utils import (JAX_PKG, PARITY_THREADS, PORT_PKG,
                               fill_variables, torch_threads)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = {
    'DoubleHeadRCNN': 'configs/double_heads/dh_faster_rcnn_r50_fpn_1x.py',
    'DynamicRCNN': 'configs/dynamic_rcnn/dynamic_rcnn_r50_fpn_1x.py',
    'GridRCNN': 'configs/grid_rcnn/grid_rcnn_r50_fpn_gn-head_1x.py',
    'MaskScoringRCNN': 'configs/ms_rcnn/ms_rcnn_r50_fpn_1x.py',
    'PointRend': 'configs/point_rend/point_rend_r50_fpn_1x.py',
    'FasterRCNNFPN/groie': 'configs/groie/faster_rcnn_r50_fpn_groie_1x.py',
    'MaskRCNN/groie': 'configs/groie/mask_rcnn_r50_fpn_groie_1x.py',
    'GridRCNN/groie': 'configs/groie/grid_rcnn_r50_fpn_gn-head_groie_1x.py'}
NUM_SAMPLES = 32
PROPOSALS = 256
TINY = {'model.backbone_depth': 18, 'model.num_classes': 4,
        'model.rpn_proposal_cfg': dict(nms_pre=1024, max_per_img=PROPOSALS),
        'model.roi_train_cfg': dict(num_samples=NUM_SAMPLES),
        # 12 proposals an image at test time: fewer detections than the 50
        # rows, so padded (zero-area) rows reach the mask and grid heads
        'model.rpn_test_cfg': dict(max_per_img=12),
        'model.roi_test_cfg': dict(max_per_img=50),
        # one step at step count 0: a warmup lr the update can show
        'lr_config.warmup_ratio': 0.5}
STRIDES = (4, 8, 16, 32, 64)
BOX_KEYS = {'loss_rpn_cls', 'loss_rpn_bbox', 'loss_cls', 'loss_bbox'}

jts = importlib.import_module(f'{JAX_PKG}.apis.train_state')
jbuilder = importlib.import_module(f'{JAX_PKG}.models.builder')
jconfig = importlib.import_module(f'{JAX_PKG}.utils.config')
ttrain = importlib.import_module(f'{PORT_PKG}.apis.train')
tbuilder = importlib.import_module(f'{PORT_PKG}.models.builder')
tconfig = importlib.import_module(f'{PORT_PKG}.utils.config')
tprofile = importlib.import_module(f'{PORT_PKG}.tools.profile_train')
tvariants = importlib.import_module(
    f'{PORT_PKG}.models.detectors.roi_variants')
convert = importlib.import_module(f'{PORT_PKG}.utils.convert')


def sampler_priorities(batch, rpn_key, roi_key):
    """The port's priorities equal to what the JAX samplers draw from the
    fixed keys: the RPN's over the anchors, the RoI sampler's over the gt
    boxes and the proposals."""
    b, h, w = batch['image'].shape[:3]
    anchors = 3 * sum(-(-h // s) * -(-w // s) for s in STRIDES)
    g = batch['gt_bboxes'].shape[1]
    pri = dict(rpn=jax.random.uniform(rpn_key, (anchors,)),
               rcnn=jax.random.uniform(roi_key, (g + PROPOSALS,)))
    return {k: _t(v).expand(b, -1) for k, v in pri.items()}


def variant_case(name, seed, extra=None):
    """One train step and `predict` of the tiny detector of CONFIGS[name]
    on both sides from the same weights."""
    path = str(ROOT / CONFIGS[name])
    options = dict(TINY, **(extra or {}))
    jcfg = jconfig.Config.fromfile(path)
    jcfg.merge_from_dict(options)
    model = jbuilder.build_detector(jcfg.model)
    batch = {k: v[:1] for k, v in _demo_batch().items()}
    batch['gt_labels'] = np.random.RandomState(9).randint(
        0, 4, batch['gt_labels'].shape).astype(np.int32)
    batch['gt_masks'] = tprofile.ellipse_masks(np.random.RandomState(6),
                                               batch['gt_valid'].shape, 28)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    k0 = jax.random.PRNGKey(0)
    dummy = dict(image=jnp.zeros((1, 64, 64, 3)),
                 img_shape=jnp.full((1, 2), 64, jnp.int32))
    shapes = jax.eval_shape(lambda: model.init(
        {'params': k0, 'sampler': k0, 'dropout': k0}, dummy, train=False))
    rs = np.random.RandomState(seed)
    variables = regression_init(fill_variables(shapes, rs), rs)

    cfg = tconfig.Config.fromfile(path)
    cfg.merge_from_dict(options)
    trainer = ttrain.init_trainer(cfg, variables=variables, device='cpu',
                                  steps_per_epoch=1)
    rs = np.random.RandomState(3)
    image = rs.standard_normal((2, 96, 160, 3)).astype(np.float32)
    img_shape = np.array([[96, 160], [80, 128]], np.int32)
    ref = jax.jit(lambda v, bt: model.apply(v, bt, train=False))(
        variables, dict(image=jnp.asarray(image),
                        img_shape=jnp.asarray(img_shape)))
    got = trainer.model.predict(dict(image=_t(image),
                                     img_shape=_t(img_shape)))

    spec = jts.OptimizerSpec(**trainer.spec._asdict())
    jstate, tx = jts.create_train_state(model, variables, spec,
                                        frozen_stages=1)
    jstep = jax.jit(jts.make_train_step(model, tx))
    rpn_key, roi_key = jax.random.PRNGKey(21), jax.random.PRNGKey(22)
    with _jax_fixed_samplers(rpn_key, roi_key):
        jstate, jm = jstep(jstate, jbatch, jax.random.PRNGKey(3))
    with torch_threads(PARITY_THREADS):
        state, tm = trainer.step(
            trainer.state, {k: _t(v) for k, v in batch.items()},
            sampler_priorities=sampler_priorities(batch, rpn_key, roi_key))

    def run_steps(n):
        """`n` steps of each side afresh from the same weights, every step
        on the batch with the samplers' first draws → [(JAX metrics, port
        metrics)] a step."""
        js = jts.create_train_state(model, variables, spec,
                                    frozen_stages=1)[0]
        tr = ttrain.init_trainer(cfg, variables=variables, device='cpu',
                                 steps_per_epoch=1)
        st, out = tr.state, []
        pri = sampler_priorities(batch, rpn_key, roi_key)
        for _ in range(n):
            with _jax_fixed_samplers(rpn_key, roi_key):
                js, jm_i = jstep(js, jbatch, jax.random.PRNGKey(3))
            with torch_threads(PARITY_THREADS):
                st, tm_i = tr.step(st, {k: _t(v) for k, v in batch.items()},
                                   sampler_priorities=pri)
            out.append(({k: float(v) for k, v in jm_i.items()},
                        {k: float(v) for k, v in tm_i.items()}))
        return out

    return dict(jstate=jax.device_get(jstate),
                jmetrics=jax.tree_util.tree_map(np.asarray, jm),
                run_steps=run_steps,
                tmetrics={k: v.numpy() for k, v in tm.items()},
                trainer=trainer, state=state, variables=variables,
                batch=batch, ref=jax.tree_util.tree_map(np.asarray, ref),
                got={k: v.numpy() for k, v in got.items()})


# (weight seed, loss keys)
CASES = {'DoubleHeadRCNN': (0, BOX_KEYS),
         'DynamicRCNN': (0, BOX_KEYS)}


@pytest.fixture(scope='module', params=sorted(CASES))
def case(request):
    return request.param, variant_case(request.param, CASES[request.param][0])


def test_variant_losses_match(case):
    name, c = case
    check_losses(c, CASES[name][1])


def test_variant_sgd_update_matches(case):
    name, c = case
    check_update(c)


def test_variant_predict_matches(case):
    name, c = case
    check_predict(c, False)

