"""The train step: the port's losses, assignment, sampling, RPN and RoI
losses, SGD, lr schedule and hooks against the JAX package's, and two whole
train steps of the tiny-fixture DAF detector on both sides.

Inputs come from numpy seeds. The samplers of both sides rank candidates by
the same priorities: the port is handed `jax.random.uniform(key, (n,))`.
Tolerances are stated per test; where both sides compute the same float32
expression in another order they agree to a few ulps, and 1e-5 relative
leaves headroom.
"""

import contextlib
import importlib
import pathlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .torch_port_utils import (JAX_PKG, PARITY_THREADS, PORT_PKG, fill_variables,
                               torch_threads)

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = str(ROOT / 'configs/da/faster_rcnn_r18_tiny_fixture.py')

jlosses = importlib.import_module(f'{JAX_PKG}.models.losses')
jassign = importlib.import_module(f'{JAX_PKG}.core.bbox.assigners')
jsamplers = importlib.import_module(f'{JAX_PKG}.core.bbox.samplers')
janchor = importlib.import_module(f'{JAX_PKG}.core.anchors.anchor_generator')
jrpn = importlib.import_module(f'{JAX_PKG}.models.dense_heads.rpn_head')
jroi = importlib.import_module(f'{JAX_PKG}.models.roi_heads.standard_roi_head')
jts = importlib.import_module(f'{JAX_PKG}.apis.train_state')
jtrain = importlib.import_module(f'{JAX_PKG}.apis.train')
jhooks = importlib.import_module(f'{JAX_PKG}.apis.hooks')
jbuilder = importlib.import_module(f'{JAX_PKG}.models.builder')
jconfig = importlib.import_module(f'{JAX_PKG}.utils.config')

tlosses = importlib.import_module(f'{PORT_PKG}.models.losses')
tassign = importlib.import_module(f'{PORT_PKG}.core.bbox.assigners')
tsamplers = importlib.import_module(f'{PORT_PKG}.core.bbox.samplers')
tanchor = importlib.import_module(f'{PORT_PKG}.core.anchors.anchor_generator')
trpn = importlib.import_module(f'{PORT_PKG}.models.dense_heads.rpn_head')
troi = importlib.import_module(f'{PORT_PKG}.models.roi_heads.standard_roi_head')
tts = importlib.import_module(f'{PORT_PKG}.apis.train_state')
thooks = importlib.import_module(f'{PORT_PKG}.apis.hooks')
ttrain = importlib.import_module(f'{PORT_PKG}.apis.train')
tconfig = importlib.import_module(f'{PORT_PKG}.utils.config')
convert = importlib.import_module(f'{PORT_PKG}.utils.convert')


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64), rtol=rtol,
                               atol=atol)


def _boxes(rs, shape, extent, min_size=2.0, max_size=None):
    """(..., 4) xyxy float32 boxes inside [0, extent)."""
    max_size = max_size or extent / 2
    xy = rs.uniform(0, extent - max_size, shape + (2,))
    wh = rs.uniform(min_size, max_size, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@contextlib.contextmanager
def _jax_fixed_samplers(rpn_key, roi_key):
    """Make the JAX package's RPN and RoI samplers draw their priorities
    from fixed keys (the same for every image and step), restoring the
    module attributes afterwards."""
    orig = jsamplers.random_sample
    saved = jrpn.random_sample, jroi.random_sample
    jrpn.random_sample = lambda rng, *a, **k: orig(rpn_key, *a, **k)
    jroi.random_sample = lambda rng, *a, **k: orig(roi_key, *a, **k)
    try:
        yield
    finally:
        jrpn.random_sample, jroi.random_sample = saved


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, fnn.Dropout) and \
            context.method_name == '__call__':
        return args[0]
    return next_fun(*args, **kwargs)


# ---- losses --------------------------------------------------------------

@pytest.mark.parametrize('reduction', ['none', 'mean', 'sum'])
def test_losses_match(reduction):
    rs = np.random.RandomState(0)
    logits = rs.standard_normal((6, 5)).astype(np.float32) * 3
    labels = rs.randint(0, 6, (6,)).astype(np.int32)   # 5 = background
    weight = rs.uniform(0, 1, (6,)).astype(np.float32)
    pred = rs.standard_normal((6, 4)).astype(np.float32)
    target = pred + rs.standard_normal((6, 4)).astype(np.float32)
    pairs = [
        (jlosses.softmax_cross_entropy(logits, labels),
         tlosses.softmax_cross_entropy(_t(logits), _t(labels))),
        (jlosses.cross_entropy(logits, labels, weight, reduction),
         tlosses.cross_entropy(_t(logits), _t(labels), _t(weight),
                               reduction)),
        (jlosses.binary_cross_entropy(logits, labels, weight, reduction),
         tlosses.binary_cross_entropy(_t(logits), _t(labels), _t(weight),
                                      reduction)),
        (jlosses.binary_cross_entropy(logits[:, 0], (labels > 2).astype(
            np.float32), None, reduction),
         tlosses.binary_cross_entropy(_t(logits[:, 0]), _t(
             (labels > 2).astype(np.float32)), None, reduction)),
        (jlosses.smooth_l1_loss(pred, target, weight[:, None], 0.5,
                                reduction),
         tlosses.smooth_l1_loss(_t(pred), _t(target), _t(weight[:, None]),
                                0.5, reduction)),
        (jlosses.sigmoid_focal_loss(logits, labels, weight,
                                    reduction=reduction),
         tlosses.sigmoid_focal_loss(_t(logits), _t(labels), _t(weight),
                                    reduction=reduction)),
        (jlosses.weight_reduce_loss(pred, weight[:, None], reduction, 7.0),
         tlosses.weight_reduce_loss(_t(pred), _t(weight[:, None]), reduction,
                                    7.0)),
    ]
    for ref, got in pairs:
        _close(got.numpy(), ref)


# ---- assignment and sampling --------------------------------------------

def _assign_inputs(seed, n=300, g=6):
    rs = np.random.RandomState(seed)
    gt = _boxes(rs, (2, g), 96.0, 8, 40)
    priors = _boxes(rs, (n,), 96.0, 4, 48)
    # exact copies of gt boxes, one gt twice: low-quality ties to resolve
    priors[:g] = gt[0]
    gt[0, 3] = gt[0, 1]
    gt_valid = np.arange(g)[None, :] < np.array([[5], [0]])   # 2nd: no gt
    gt_labels = rs.randint(0, 3, (2, g)).astype(np.int32)
    img_shape = np.array([[80, 96], [96, 70]], np.int32)
    return priors, gt, gt_valid, gt_labels, img_shape


@pytest.mark.parametrize('match_low_quality', [True, False])
def test_max_iou_assign_matches(match_low_quality):
    priors, gt, gt_valid, gt_labels, img_shape = _assign_inputs(0)
    kw = dict(pos_iou_thr=0.6, neg_iou_thr=0.3, min_pos_iou=0.2,
              match_low_quality=match_low_quality)
    for i in range(2):
        inside = janchor.anchor_inside_flags(jnp.asarray(priors),
                                             jnp.asarray(img_shape[i]), 0)
        tinside = tanchor.anchor_inside_flags(_t(priors), _t(img_shape[i]))
        np.testing.assert_array_equal(tinside.numpy(), np.asarray(inside))
        ref = jassign.max_iou_assign(priors, gt[i], gt_valid[i],
                                     gt_labels[i], prior_valid=inside, **kw)
        got = tassign.max_iou_assign(_t(priors), _t(gt[i]), _t(gt_valid[i]),
                                     _t(gt_labels[i]), prior_valid=tinside,
                                     **kw)
        np.testing.assert_array_equal(got.assigned_gt_inds.numpy(),
                                      np.asarray(ref.assigned_gt_inds))
        np.testing.assert_array_equal(got.labels.numpy(),
                                      np.asarray(ref.labels))
        _close(got.max_overlaps.numpy(), ref.max_overlaps)
    # the later of two gts claiming the same prior wins it
    if match_low_quality:
        ref0 = tassign.max_iou_assign(_t(priors), _t(gt[0]), _t(gt_valid[0]),
                                      **kw)
        assert ref0.assigned_gt_inds[1].item() == 4


@pytest.mark.parametrize('num,frac,n_pos', [(64, 0.25, 40), (64, 0.5, 5),
                                            (512, 0.25, 3)])
def test_random_sample_matches(num, frac, n_pos):
    rs = np.random.RandomState(num + n_pos)
    n = 300
    agi = np.full((n,), -1, np.int32)
    agi[rs.permutation(n)[:200]] = 0
    agi[rs.permutation(n)[:n_pos]] = rs.randint(1, 5, n_pos)
    key = jax.random.PRNGKey(n_pos)
    ref = jsamplers.random_sample(key, jnp.asarray(agi), num, frac)
    pri = _t(jax.random.uniform(key, (n,)))
    got = tsamplers.random_sample(_t(agi), num, frac, priorities=pri)
    for name in ('inds', 'is_pos', 'valid', 'pos_mask', 'neg_mask'):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    # drawn from a generator instead: same quotas
    drawn = tsamplers.random_sample(
        _t(agi), num, frac, generator=torch.Generator().manual_seed(0))
    assert int(drawn.pos_mask.sum()) == int(ref.pos_mask.sum())
    assert int(drawn.neg_mask.sum()) == int(ref.neg_mask.sum())


# ---- RPN and RoI losses ---------------------------------------------------

def _rpn_inputs(seed=0, b=2, h=4, w=6, a=6):
    rs = np.random.RandomState(seed)
    cls = rs.standard_normal((b, h, w, a)).astype(np.float32)
    reg = 0.3 * rs.standard_normal((b, h, w, a * 4)).astype(np.float32)
    cfg = janchor.AnchorGenerator(strides=[16], ratios=[0.5, 1.0, 2.0],
                                  scales=[1, 2])
    anchors = np.asarray(cfg.grid_priors([(h, w)])[0], np.float32)
    gt = _boxes(rs, (b, 5), 64.0, 10, 30)
    gt_valid = np.arange(5)[None, :] < np.array([[4], [3]])
    img_shape = np.array([[64, 96], [60, 90]], np.int32)
    return cls, reg, anchors, gt, gt_valid, img_shape


@pytest.mark.parametrize('masked', [False, True])
def test_rpn_loss_matches(masked):
    cls, reg, anchors, gt, gt_valid, img_shape = _rpn_inputs()
    jcfg = jrpn.RPNTrainConfig(num_samples=64)
    mask = np.array([1.0, 0.0], np.float32) if masked else None
    rng = jax.random.PRNGKey(5)
    ref = jrpn.rpn_loss(jnp.asarray(cls), jnp.asarray(reg),
                        jnp.asarray(anchors), jnp.asarray(gt),
                        jnp.asarray(gt_valid), jnp.asarray(img_shape), rng,
                        jcfg, None if mask is None else jnp.asarray(mask))
    n = anchors.shape[0]
    pri = np.stack([np.asarray(jax.random.uniform(k, (n,)))
                    for k in jax.random.split(rng, 2)])
    got = trpn.rpn_loss(_t(cls), _t(reg), _t(anchors), _t(gt), _t(gt_valid),
                        _t(img_shape), trpn.RPNTrainConfig(num_samples=64),
                        None if mask is None else _t(mask),
                        priorities=_t(pri))
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k].item(), float(ref[k]))


def _roi_inputs(seed=1, b=2, p=40, g=5):
    rs = np.random.RandomState(seed)
    gt = _boxes(rs, (b, g), 96.0, 10, 40)
    props = np.concatenate([gt + rs.uniform(-4, 4, (b, g, 4)),
                            _boxes(rs, (b, p - g), 96.0, 4, 48)], 1)
    props = props.astype(np.float32)
    prop_valid = np.arange(p)[None, :] < np.array([[p], [p - 7]])
    gt_valid = np.arange(g)[None, :] < np.array([[4], [2]])
    gt_labels = rs.randint(0, 3, (b, g)).astype(np.int32)
    return props, prop_valid, gt, gt_labels, gt_valid


def test_sample_rois_and_bbox_loss_match():
    props, prop_valid, gt, gt_labels, gt_valid = _roi_inputs()
    rng = jax.random.PRNGKey(7)
    jcfg = jroi.RoITrainConfig(num_samples=32)
    ref = jroi.sample_rois(jnp.asarray(props), jnp.asarray(prop_valid),
                           jnp.asarray(gt), jnp.asarray(gt_labels),
                           jnp.asarray(gt_valid), rng, 3, jcfg)
    n = props.shape[1] + gt.shape[1]
    pri = np.stack([np.asarray(jax.random.uniform(k, (n,)))
                    for k in jax.random.split(rng, 2)])
    tcfg = troi.RoITrainConfig(num_samples=32)
    got = troi.sample_rois(_t(props), _t(prop_valid), _t(gt), _t(gt_labels),
                           _t(gt_valid), 3, tcfg, priorities=_t(pri))
    assert int(np.asarray(ref.is_pos).sum()) > 0
    for name in ('labels', 'label_valid', 'is_pos', 'matched_gt'):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    _close(got.rois.numpy(), ref.rois)
    _close(got.reg_targets.numpy(), ref.reg_targets, atol=1e-5)

    rs = np.random.RandomState(2)
    cls = rs.standard_normal((2, 32, 4)).astype(np.float32)
    reg = rs.standard_normal((2, 32, 12)).astype(np.float32)
    mask = np.array([1.0, 0.0], np.float32)
    for m in (None, mask):
        jl = jroi.bbox_loss(jnp.asarray(cls), jnp.asarray(reg), ref, 3, jcfg,
                            None if m is None else jnp.asarray(m))
        tl = troi.bbox_loss(_t(cls), _t(reg), got, 3, tcfg,
                            None if m is None else _t(m))
        for k in jl:
            _close(tl[k].item(), float(jl[k]))
    # the softmax classifier path
    jl = jroi.bbox_loss(jnp.asarray(cls), jnp.asarray(reg), ref, 3,
                        jcfg._replace(use_sigmoid_cls=False))
    tl = troi.bbox_loss(_t(cls), _t(reg), got, 3,
                        tcfg._replace(use_sigmoid_cls=False))
    _close(tl['loss_cls'].item(), float(jl['loss_cls']))


# ---- optimizer and hooks -------------------------------------------------

def test_lr_schedule_matches():
    spec = tts.OptimizerSpec(lr=0.02, warmup_iters=10, warmup_ratio=0.1,
                             decay_steps=(12, 15))
    jsched = jts.make_lr_schedule(jts.OptimizerSpec(**spec._asdict()))
    tsched = tts.make_lr_schedule(spec)
    for step in range(0, 20):
        _close(tsched(step), float(jsched(step)), rtol=1e-6)
    with pytest.raises(NotImplementedError):
        tts.make_lr_schedule(spec._replace(policy='cosine'))


def _param_trees(seed):
    rs = np.random.RandomState(seed)
    shapes = {'backbone': {'trunk': {'conv1': {'kernel': (3, 3, 3, 4)},
                                     'layer1': {'0': {'conv1': {
                                         'kernel': (1, 1, 4, 4)}}},
                                     'layer2': {'0': {'conv1': {
                                         'kernel': (1, 1, 4, 4)}}}}},
              'head': {'kernel': (5, 3), 'bias': (3,)}}

    def fill(t):
        return {k: fill(v) if isinstance(v, dict) else
                rs.standard_normal(v).astype(np.float32)
                for k, v in t.items()}
    return fill(shapes), fill(shapes)


def _flat(tree, prefix=''):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f'{prefix}{k}.'))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize('grad_clip', [None, 1.0])
def test_fused_sgd_matches(grad_clip):
    params, grads = _param_trees(0)
    spec = tts.OptimizerSpec(lr=0.05, warmup_iters=3, warmup_ratio=0.2,
                             grad_clip=grad_clip)
    jp = {'backbone': {'trunk': {
        'conv1': params['backbone']['trunk']['conv1'],
        'layer1/0': params['backbone']['trunk']['layer1']['0'],
        'layer2/0': params['backbone']['trunk']['layer2']['0']}},
        'head': params['head']}
    jg = jax.tree_util.tree_map(lambda x: x, jp)
    jg['backbone']['trunk']['conv1'] = grads['backbone']['trunk']['conv1']
    jg['backbone']['trunk']['layer1/0'] = \
        grads['backbone']['trunk']['layer1']['0']
    jg['backbone']['trunk']['layer2/0'] = \
        grads['backbone']['trunk']['layer2']['0']
    jg['head'] = grads['head']
    jtx = jts.make_optimizer(jts.OptimizerSpec(**spec._asdict()), jp, 1)
    jstate = jtx.init(jp)
    tp = {k: _t(v).clone() for k, v in _flat(params).items()}
    tg = {k: _t(v).clone() for k, v in _flat(grads).items()}
    mask = tts.frozen_mask(tp, 1)
    assert [k for k, v in mask.items() if not v] == [
        'backbone.trunk.conv1.kernel', 'backbone.trunk.layer1.0.conv1.kernel']
    ttx = tts._FusedSGD(spec, mask)
    tstate = ttx.init(tp)
    for _ in range(3):      # momentum and the warmup both count
        jp, jstate = jtx.fused_apply(jg, jstate, jp)
        tp, tstate = ttx.fused_apply({k: v.clone() for k, v in tg.items()},
                                     tstate, tp)
    ref = _flat({'backbone': {'trunk': {
        'conv1': jp['backbone']['trunk']['conv1'],
        'layer1': {'0': jp['backbone']['trunk']['layer1/0']},
        'layer2': {'0': jp['backbone']['trunk']['layer2/0']}}},
        'head': jp['head']})
    for k in ref:
        _close(tp[k].numpy(), ref[k])
    _close(tstate.momentum['head.kernel'].numpy(),
           jstate.momentum['head']['kernel'])
    assert tstate.count == int(jstate.count) == 3


def test_grad_clip_norm_matches_jax_on_a_long_tensor():
    """The clip factor over a 4 M-element gradient (a Shared2FC weight's
    size class) within 1e-6 relative of the JAX package's: the CPU's
    `vector_norm` alone adds the squares one by one in f32 and is ~1e-4
    off at this length."""
    rs = np.random.RandomState(3)
    grads = {'fc.weight': rs.standard_normal((1024, 4096)).astype(np.float32),
             'fc.bias': rs.standard_normal((1024,)).astype(np.float32)}
    spec = tts.OptimizerSpec(grad_clip=35.0)
    jtx = jts.make_optimizer(jts.OptimizerSpec(**spec._asdict()), grads)
    ref = float(jtx._grad_scale(grads))
    got = tts._FusedSGD(spec, dict.fromkeys(grads, True)).grad_scale(
        [_t(g) for g in grads.values()])
    _close(float(got), ref, rtol=1e-6, atol=0)
    assert ref < 1


def test_ema_and_guard_match():
    params, new = _param_trees(1)
    tp = {k: _t(v) for k, v in _flat(params).items()}
    tn = {k: _t(v) for k, v in _flat(new).items()}
    ema = {k: v.clone() for k, v in tn.items()}
    ref = jhooks.ema_update(_flat(new), _flat(params), 0.9995, step=700)
    got = thooks.ema_update(ema, tp, 0.9995, step=700)
    for k in ref:
        _close(got[k].numpy(), ref[k])
    for loss, poison in ((1.0, False), (float('nan'), False), (1.0, True)):
        bad = dict(tn)
        if poison:
            bad['head.bias'] = tn['head.bias'] * float('inf')
        jref, jskip = jhooks.guard_nonfinite_update(
            _flat(params), {k: v.numpy() for k, v in bad.items()},
            jnp.float32(loss))
        got, skip = thooks.guard_nonfinite_update(tp, bad,
                                                  torch.tensor(loss))
        assert bool(skip) == bool(jskip)
        for k in jref:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(jref[k]))


@pytest.mark.parametrize('steps_per_epoch', [1, 2975])
def test_optimizer_spec_matches_jax_runner(steps_per_epoch):
    """The flagship's epoch-based schedule turns into steps as the JAX
    package's `resolve_runner` turns it, given the loader's length; without
    that length `init_trainer` raises rather than guess it."""
    cfg = tconfig.Config.fromfile(
        str(ROOT / 'configs/da/faster_rcnn_r50_daf_c2f.py'))
    spec = ttrain.optimizer_spec(cfg, steps_per_epoch)
    _, epochs, _, milestones = jtrain.resolve_runner(
        cfg['runner'], cfg['lr_config'], steps_per_epoch)
    assert spec.decay_steps == tuple(milestones)
    assert spec.total_steps == epochs * steps_per_epoch
    assert spec.warmup_iters == 500 and spec.grad_clip == 35
    with pytest.raises(ValueError, match='steps_per_epoch'):
        ttrain.init_trainer(cfg, device='cpu')


# ---- two whole train steps -----------------------------------------------

def _demo_batch(b=2, h=128, w=192, g=6, seed=4):
    rs = np.random.RandomState(seed)
    boxes = _boxes(rs, (b, g), 64.0, 10, 30)
    return dict(image=rs.standard_normal((b, h, w, 3)).astype(np.float32),
                img_shape=np.array([[h, w]] * b, np.int32),
                gt_bboxes=boxes,
                gt_labels=rs.randint(0, 2, (b, g)).astype(np.int32),
                gt_valid=np.arange(g)[None, :] < np.array([[4], [3]]),
                domain=np.array([0, 1], np.int32))


def _tiny_cfg():
    cfg = tconfig.Config.fromfile(TINY)
    cfg.merge_from_dict({
        'optimizer.lr': 0.002, 'lr_config.warmup_iters': 4,
        'lr_config.warmup_ratio': 0.5, 'lr_config.step': [1],
        'optimizer_config': dict(grad_clip=dict(max_norm=5.0)),
        'ema': dict(momentum=0.9995)})
    return cfg


@pytest.fixture(scope='module')
def two_steps():
    """Two steps of the tiny-fixture DAF detector on both sides from the
    same weights, with dropout off and the same sampler priorities.

    The canvas is 128x192: at 64x96 the global heads' live BatchNorm sees
    4 values per channel, and its backward (a difference of means) loses
    ~5e-4 of their gradient to rounding on either side. The weights' seed
    is one whose second step flips no ReLU unit between the two sides (at
    this size most seeds put some pre-activation within float error of 0
    after the first update, which moves a rank-one piece of a weight
    gradient by percents)."""
    cfg = _tiny_cfg()
    jcfg = jconfig.Config.fromfile(TINY)
    model = jbuilder.build_detector(jcfg.model)
    batch = _demo_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    k0 = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: model.init(
        {'params': k0, 'sampler': k0, 'dropout': k0}, jbatch, train=True))
    variables = fill_variables(shapes, np.random.RandomState(5))

    trainer = ttrain.init_trainer(cfg, variables=variables, device='cpu',
                                  steps_per_epoch=1)
    spec = jts.OptimizerSpec(**trainer.spec._asdict())
    jstate, tx = jts.create_train_state(model, variables, spec,
                                        frozen_stages=1, ema=True)
    jstep = jax.jit(jts.make_train_step(model, tx, skip_nonfinite=True,
                                        ema_momentum=0.9995))
    rpn_key, roi_key = jax.random.PRNGKey(21), jax.random.PRNGKey(22)
    h, w = batch['image'].shape[1:3]
    anchors = (h // 16) * (w // 16) * model.anchor_cfg.num_anchors
    cands = batch['gt_bboxes'].shape[1] + model.rpn_proposal_cfg.max_per_img
    pri = dict(rpn=_t(jax.random.uniform(rpn_key, (anchors,))).expand(2, -1),
               rcnn=_t(jax.random.uniform(roi_key, (cands,))).expand(2, -1))

    for m in trainer.model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    tbatch = {k: _t(v) for k, v in batch.items()}
    jmetrics, tmetrics = [], []
    state = trainer.state
    with _jax_fixed_samplers(rpn_key, roi_key), \
            fnn.intercept_methods(_no_dropout):
        # XLA:CPU's algebraic simplifier turns the global heads' input
        # gradients into NaN in this jitted step (op by op it is finite),
        # so the step is compiled without that pass
        jstep = jstep.lower(jstate, jbatch, jax.random.PRNGKey(3)).compile(
            compiler_options={'xla_disable_hlo_passes': 'algsimp'})
        for _ in range(2):
            jstate, m = jstep(jstate, jbatch, jax.random.PRNGKey(3))
            jmetrics.append(jax.tree_util.tree_map(np.asarray, m))
            with torch_threads(PARITY_THREADS):
                state, m = trainer.step(state, tbatch,
                                        sampler_priorities=pri)
            tmetrics.append({k: v.numpy() for k, v in m.items()})
    return dict(jstate=jax.device_get(jstate), jmetrics=jmetrics,
                trainer=trainer, state=state, tmetrics=tmetrics,
                variables=variables)


def test_train_steps_losses_match(two_steps):
    """Per-term losses of both steps within 1e-5 relative: the same
    forward, summed in another order (they agree to ~2e-6)."""
    for jm, tm in zip(two_steps['jmetrics'], two_steps['tmetrics']):
        assert set(tm) == set(jm)
        assert {'loss_rpn_cls', 'loss_rpn_bbox', 'loss_cls', 'loss_bbox',
                'globle_da_loss', 'patch_bottom_loss',
                'local_da_loss'} <= set(tm)
        for k in jm:
            assert np.isfinite(tm[k])
            _close(tm[k], jm[k], rtol=1e-5, atol=1e-6)
        assert tm['skipped_nonfinite'] == 0


def _converted(tree, model):
    state, unmapped = convert.from_jax_variables(tree, model)
    assert unmapped == []
    return state


def _close_scaled(got, ref, tol=1e-4, floor=1.0, name=''):
    """|got − ref| within `tol` of max(floor, max |ref|), element-wise (in
    plain numpy: `numpy.testing` costs seconds over a train state's many
    large tensors)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    if not ref.size:
        return
    scale = max(floor, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f'{name}: {err:.3e} > {tol} x {scale:.3e}'


def test_train_steps_state_matches(two_steps):
    """Updated params, DA-head batch stats and EMA within 1e-4 of scale;
    the momentum (the clipped gradients) within 1e-4 of each tensor's
    largest entry, or of 1e-3 where that is smaller: the non-local heads'
    theta/phi gradients are ~1e-4 in size, sums of terms a thousand times
    larger (the worst tensor agrees to ~5e-5). The frozen stem and layer1
    bit-identical to the start."""
    trainer, jstate, state = (two_steps['trainer'], two_steps['jstate'],
                              two_steps['state'])
    model = trainer.model
    ref = _converted({'params': jstate.params,
                      'batch_stats': jstate.batch_stats}, model)
    got = model.state_dict()
    start = _converted(two_steps['variables'], model)
    assert state.step == 2 and state.opt_state.count == 2
    params = dict(model.named_parameters())
    for k, v in got.items():
        _close_scaled(v.numpy(), ref[k].numpy())
        frozen = k.startswith(('backbone.trunk.conv1', 'backbone.trunk.bn1',
                               'backbone.trunk.layer1.'))
        if frozen:
            np.testing.assert_array_equal(v.numpy(), start[k].numpy())
        elif k in params:
            assert not np.array_equal(v.numpy(), start[k].numpy()), k
    assert any(k.endswith('.var') and 'backbone.global_s' in k
               and not np.array_equal(got[k].numpy(), start[k].numpy())
               for k in got)

    mom = _converted({'params': jstate.opt_state.momentum}, model)
    for k, m in state.opt_state.momentum.items():
        _close_scaled(m.numpy(), mom[k].numpy(), 1e-4, floor=1e-3)
    ema = _converted({'params': jstate.ema_params}, model)
    for k, e in state.ema_params.items():
        _close_scaled(e.numpy(), ema[k].numpy())
