"""The cascade family against the JAX package: Cascade R-CNN and Cascade
Mask R-CNN (`configs/cascade_rcnn/cascade_{,mask_}rcnn_r50_fpn_1x.py` with
an R18 trunk, 4 classes and 32 RoIs a stage), from the same weights: one
train step on an image of 128x192 with seeded box-frame rasters of 28x28,
every sampler's priorities fixed on both sides, and `predict` on two
images; then the builder on the full-width configs and the options that
raise.

`cascade_case` is shared with `test_torch_htc.py` (HTC and SCNet).
Tolerances: each loss term within 1e-4 relative; after the step the
momentum (the gradient plus weight decay) within 1e-4 of the whole
update's scale and 5e-3 of each tensor's (see `check_update`);
`predict`'s detections within 1e-3 with labels and validity identical,
and the masks of every detection row, padded ones included, within 1e-4.
One JAX compile of the train step and one of `predict` a model.
"""

import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .test_torch_train import _demo_batch, _jax_fixed_samplers
from .torch_port_utils import JAX_PKG, PORT_PKG, fill_variables

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = {
    'CascadeRCNN': str(ROOT / 'configs/cascade_rcnn/cascade_rcnn_r50_fpn_1x.py'),
    'CascadeMaskRCNN': str(
        ROOT / 'configs/cascade_rcnn/cascade_mask_rcnn_r50_fpn_1x.py'),
    'HTC': str(ROOT / 'configs/htc/htc_r50_fpn_1x.py'),
    'SCNet': str(ROOT / 'configs/scnet/scnet_r50_fpn_1x.py')}
NUM_SAMPLES = 32
PROPOSALS = 256
TINY = {'model.backbone_depth': 18, 'model.num_classes': 4,
        'model.num_samples': NUM_SAMPLES,
        'model.rpn_proposal_cfg': dict(nms_pre=1024, max_per_img=PROPOSALS),
        # 12 proposals an image at test time: fewer detections than the 50
        # rows, so padded (zero-area) rows reach the mask branch
        'model.rpn_test_cfg': dict(max_per_img=12),
        'model.roi_test_cfg': dict(max_per_img=50),
        # one step at step count 0: a warmup lr the update can show
        'lr_config.warmup_ratio': 0.5}
FROZEN = ('backbone.conv1', 'backbone.bn1', 'backbone.layer1.')
STRIDES = (4, 8, 16, 32, 64)

jts = importlib.import_module(f'{JAX_PKG}.apis.train_state')
jbuilder = importlib.import_module(f'{JAX_PKG}.models.builder')
jconfig = importlib.import_module(f'{JAX_PKG}.utils.config')
ttrain = importlib.import_module(f'{PORT_PKG}.apis.train')
tbuilder = importlib.import_module(f'{PORT_PKG}.models.builder')
tconfig = importlib.import_module(f'{PORT_PKG}.utils.config')
tprofile = importlib.import_module(f'{PORT_PKG}.tools.profile_train')
tcascade = importlib.import_module(f'{PORT_PKG}.models.detectors.cascade_rcnn')
convert = importlib.import_module(f'{PORT_PKG}.utils.convert')


def _t(x):
    return torch.from_numpy(np.array(x))


def regression_init(variables, rs):
    """The RPN's and every box head's regression kernels redrawn at mmdet's
    init scale (std 0.01 and 0.001), as `test_torch_fpn.regression_init`
    does for one box head: at 1/sqrt(fan_in) the three decodes turn f32
    noise into visible box differences."""
    for name, module in variables['params'].items():
        for layer, std in (('rpn_reg', 0.01), ('fc_reg', 0.001)):
            if layer in module:
                k = module[layer]['kernel']
                module[layer]['kernel'] = (rs.standard_normal(k.shape) *
                                           std).astype(np.float32)
    return variables


def sampler_priorities(batch, rpn_key, roi_key):
    """The port's sampler priorities that equal what the JAX samplers draw
    from the fixed keys: the RPN's over the anchors, and each stage's over
    its candidates (the gt boxes, then the proposals or the previous
    stage's samples)."""
    b, h, w = batch['image'].shape[:3]
    anchors = 3 * sum(-(-h // s) * -(-w // s) for s in STRIDES)
    g = batch['gt_bboxes'].shape[1]
    pri = dict(rpn=jax.random.uniform(rpn_key, (anchors,)))
    for i in range(tcascade.NUM_STAGES):
        cands = g + (PROPOSALS if i == 0 else NUM_SAMPLES)
        pri[tcascade.stage_priority_key(i)] = jax.random.uniform(
            roi_key, (cands,))
    return {k: _t(v).expand(b, -1) for k, v in pri.items()}


def cascade_case(name, seed, batch_extra=None):
    """One train step and `predict` of the tiny `name` detector on both
    sides from the same weights."""
    jcfg = jconfig.Config.fromfile(CONFIGS[name])
    jcfg.merge_from_dict(TINY)
    model = jbuilder.build_detector(jcfg.model)
    # the step on one image (of `_demo_batch`'s two): the mask heads' convs
    # over every stage's RoIs set the CPU time of both sides
    batch = {k: v[:1] for k, v in _demo_batch().items()}
    batch['gt_labels'] = np.random.RandomState(9).randint(
        0, 4, batch['gt_labels'].shape).astype(np.int32)
    batch['gt_masks'] = tprofile.ellipse_masks(np.random.RandomState(6),
                                               batch['gt_valid'].shape, 28)
    batch.update({k: v[:1] for k, v in (batch_extra or {}).items()})
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    k0 = jax.random.PRNGKey(0)
    # the variables from the serving path (it creates every parameter the
    # loss uses) on a small image: a cheaper trace than the loss
    dummy = dict(image=jnp.zeros((1, 64, 64, 3)),
                 img_shape=jnp.full((1, 2), 64, jnp.int32))
    shapes = jax.eval_shape(lambda: model.init(
        {'params': k0, 'sampler': k0, 'dropout': k0}, dummy, train=False))
    rs = np.random.RandomState(seed)
    variables = regression_init(fill_variables(shapes, rs), rs)

    cfg = tconfig.Config.fromfile(CONFIGS[name])
    cfg.merge_from_dict(TINY)
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
    state, tm = trainer.step(
        trainer.state, {k: _t(v) for k, v in batch.items()},
        sampler_priorities=sampler_priorities(batch, rpn_key, roi_key))
    return dict(jstate=jax.device_get(jstate),
                jmetrics=jax.tree_util.tree_map(np.asarray, jm),
                tmetrics={k: v.numpy() for k, v in tm.items()},
                trainer=trainer, state=state, variables=variables,
                ref=jax.tree_util.tree_map(np.asarray, ref),
                got={k: v.numpy() for k, v in got.items()})


def check_losses(case, keys):
    jm, tm = case['jmetrics'], case['tmetrics']
    assert set(tm) == set(jm) == keys | {'loss'}
    for k in jm:
        assert np.isfinite(tm[k]) and tm[k] > 0, k
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, atol=1e-7,
                                   err_msg=k)


def _converted(tree, model):
    state, unmapped = convert.from_jax_variables(tree, model)
    assert unmapped == []
    return state


def _within(got, ref, tol, scale, name):
    """max |got - ref| within `tol` x `scale` (torch, for the train state's
    many large tensors)."""
    err = float((got - ref).abs().max()) if ref.numel() else 0.0
    assert err <= tol * scale, f'{name}: {err:.3e} > {tol} x {scale:.3e}'


def _scale(t, floor):
    return max(floor, float(t.abs().max())) if t.numel() else floor


def check_update(case):
    """The momentum after the step (the gradient plus weight decay, the
    update over the lr) within 1e-4 of the whole update's scale (its
    largest entry) everywhere, and within 5e-3 of each tensor's own scale;
    the stem and layer1 frozen (no momentum, unchanged), every other
    trainable tensor moved. (A tensor's own scale is no tighter bound
    here: the port's own gradient moves by up to 1.4e-3 of a mask head
    tensor's scale between 1 and 8 CPU threads, where ReLU units sit within
    rounding of zero.)"""
    trainer, jstate, state = case['trainer'], case['jstate'], case['state']
    model = trainer.model
    assert state.step == 1
    mom = _converted({'params': jstate.opt_state.momentum}, model)
    whole = max(_scale(m, 0.0) for m in mom.values())
    for k, m in mom.items():        # the JAX state keeps frozen ones at 0
        if k.startswith(FROZEN):
            assert k not in state.opt_state.momentum and not m.any(), k
        else:
            got = state.opt_state.momentum[k]
            _within(got, m, 1e-4, whole, k)
            _within(got, m, 5e-3, _scale(m, 1e-3), k)
    start = _converted(case['variables'], model)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for k, v in model.state_dict().items():
            moved = not torch.equal(v, start[k])
            assert moved == (k in params and not k.startswith(FROZEN)), k


def check_predict(case, with_masks):
    ref, got = case['ref'], case['got']
    assert set(got) == set(ref)
    valid = ref['valid']
    assert valid.sum() >= 20 and not valid.all()
    np.testing.assert_array_equal(got['valid'], valid)
    np.testing.assert_array_equal(got['labels'], ref['labels'])
    np.testing.assert_allclose(got['dets'], ref['dets'], atol=1e-3)
    if with_masks:
        assert got['masks'].shape == (2, 50, 28, 28)
        np.testing.assert_allclose(got['masks'], ref['masks'], rtol=0,
                                   atol=1e-4)


BOX_KEYS = {'loss_rpn_cls', 'loss_rpn_bbox'} | {
    f's{i}.{k}' for i in range(3) for k in ('loss_cls', 'loss_bbox')}
# (weight seed, loss keys besides the box cascade's, masks)
CASES = {'CascadeRCNN': (5, set(), False),
         'CascadeMaskRCNN': (4, {f's{i}.loss_mask' for i in range(3)}, True)}


@pytest.fixture(scope='module', params=sorted(CASES))
def case(request):
    seed = CASES[request.param][0]
    return request.param, cascade_case(request.param, seed)


def test_cascade_losses_match(case):
    name, c = case
    check_losses(c, BOX_KEYS | CASES[name][1])


def test_cascade_sgd_update_matches(case):
    name, c = case
    check_update(c)


def test_cascade_predict_matches(case):
    name, c = case
    check_predict(c, CASES[name][2])


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_builder_reads_the_coco_config(name):
    """The full-width COCO config builds the type with its defaults: 80
    classes, 512 RoIs a stage, a 28x28 mask (the mask families), HTC's and
    SCNet's semantic branch on with 183 classes; SCNet without per-stage
    mask heads."""
    cfg = tconfig.Config.fromfile(CONFIGS[name])
    model = tbuilder.build_detector(cfg.model, device='meta')
    assert type(model).__name__ == name
    assert model.num_classes == 80 and model.num_samples == 512
    assert [type(h).__name__ for h in model.bbox_heads] == \
        ['Shared2FCBBoxHead'] * 3
    tops = {k.split('.')[0] for k in model.state_dict()}
    assert model.with_mask == (name != 'CascadeRCNN')
    assert getattr(model, 'mask_size', None) == (28 if model.with_mask
                                                 else None)
    assert ('semantic_head' in tops) == (name in ('HTC', 'SCNet'))
    if name in ('HTC', 'SCNet'):
        assert model.with_semantic and model.semantic_classes == 183
        assert model.semantic_head.logits.out_channels == 183
    assert any(t.startswith('mask_head_') for t in tops) == (
        name in ('CascadeMaskRCNN', 'HTC'))


def test_converter_maps_every_leaf_of_full_width_scnet():
    """The full-width SCNet tree (the 183-class semantic head, the relay's
    12544-row Dense) carries across with no unmapped leaf, and covers
    every tensor of the port's model: neither side has per-stage mask
    heads. The tiny steps above and in `test_torch_htc.py` carry every
    family's tree across with none either."""
    name = 'SCNet'
    cfg = jconfig.Config.fromfile(CONFIGS[name])
    model = jbuilder.build_detector(cfg.model)
    dummy = dict(image=jnp.zeros((1, 64, 64, 3)),
                 img_shape=jnp.full((1, 2), 64, jnp.int32))
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: model.init(
        {'params': k, 'sampler': k, 'dropout': k}, dummy, train=False))
    tree = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), shapes)
    port = tbuilder.build_detector(
        tconfig.Config.fromfile(CONFIGS[name]).model, device='meta')
    state, unmapped = convert.from_jax_variables(tree, port)
    assert unmapped == []
    assert set(state) == set(port.state_dict())
    assert not any(k.startswith('mask_head_') for k in state)


@pytest.mark.parametrize('override,match', [
    (dict(loss_cls='seesaw'), 'seesaw'),
    (dict(type='CascadeMaskRCNN', normed_mask=True), 'normed_mask')])
def test_builder_refuses_the_lvis_options(override, match):
    cfg = dict(type='CascadeRCNN', backbone_depth=18, num_classes=4)
    cfg.update(override)
    with pytest.raises(NotImplementedError, match=match):
        tbuilder.build_detector(cfg, device='meta')


def test_several_ranks_refuse_the_cascade_family(tmp_path):
    cfg = tconfig.Config.fromfile(CONFIGS['HTC'])
    with pytest.raises(NotImplementedError, match='several ranks'):
        ttrain.train_detector(cfg, str(tmp_path / 'wd'), n_devices=2,
                              device='cpu')
    assert not (tmp_path / 'wd').exists()
