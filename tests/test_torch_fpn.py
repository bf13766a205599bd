"""The FPN slice's modules and serving path against the JAX package's: the
FPN neck at sizes that are not multiples of 32, the flattened multi-level
RPN outputs and anchors, `FasterRCNNFPN.predict` of a tiny detector built
from the Cityscapes FPN config (R18 trunk, 64-channel neck, 2 classes), the
weight converter on the full-width config, and the builder's refusals.

Weights come from numpy seeds and are carried across by
`from_jax_variables`. Tolerances: neck and RPN within 1e-5 of the output's
scale (the same convolutions summed in another order); detections within
1e-3, labels and validity identical (seeds whose ranked scores are not
tied).
"""

import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .torch_port_utils import JAX_PKG, PORT_PKG, fill_variables

ROOT = pathlib.Path(__file__).resolve().parent.parent
FPN_CFG = str(ROOT / 'configs/cityscapes/faster_rcnn_r50_fpn_1x_cityscapes.py')
TINY = {'model.backbone_depth': 18, 'model.neck_channels': 64,
        'model.num_classes': 2}

jbuilder = importlib.import_module(f'{JAX_PKG}.models.builder')
jconfig = importlib.import_module(f'{JAX_PKG}.utils.config')
jfpn = importlib.import_module(f'{JAX_PKG}.models.necks.fpn')
tfpn = importlib.import_module(f'{PORT_PKG}.models.necks.fpn')
tbuilder = importlib.import_module(f'{PORT_PKG}.models.builder')
tconfig = importlib.import_module(f'{PORT_PKG}.utils.config')
tapis = importlib.import_module(f'{PORT_PKG}.apis.inference')
convert = importlib.import_module(f'{PORT_PKG}.utils.convert')


def _close_scaled(got, ref, tol=1e-5):
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


def _nchw(x):
    return np.asarray(x).transpose(0, 3, 1, 2)


@pytest.mark.parametrize('extra', [False, 'on_input', 'on_output'])
def test_fpn_neck_matches_jax(extra):
    """Stage sizes of a 100x140 image (not a multiple of 32): the top-down
    merge upsamples 4x5 → 7x9 → 13x18 → 25x35, where half-pixel nearest
    ('nearest-exact') and torch's plain 'nearest' differ; the extra levels
    halve odd sizes."""
    rs = np.random.RandomState(0)
    chans = (8, 16, 32, 64)
    sizes = ((25, 35), (13, 18), (7, 9), (4, 5))
    xs = [rs.standard_normal((2, h, w, c)).astype(np.float32)
          for (h, w), c in zip(sizes, chans)]
    jm = jfpn.FPN(in_channels=chans, out_channels=16, num_outs=6,
                  add_extra_convs=extra, relu_before_extra_convs=True)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            tuple(map(jnp.asarray, xs))))
    variables = fill_variables(shapes, rs)
    ref = jm.apply(variables, tuple(map(jnp.asarray, xs)))
    tm = tfpn.FPN(in_channels=chans, out_channels=16, num_outs=6,
                  add_extra_convs=extra, relu_before_extra_convs=True)
    convert.load_jax_variables(tm, variables)
    got = tm([torch.from_numpy(_nchw(x).copy()) for x in xs])
    assert len(got) == len(ref) == 6
    for g, r in zip(got, ref):
        assert tuple(g.shape) == _nchw(r).shape
        _close_scaled(g.detach().numpy(), _nchw(r))
    assert [tuple(g.shape[-2:]) for g in got[4:]] == [(2, 3), (1, 2)]


def regression_init(variables, rs):
    """Redraw the RPN's and the box head's regression kernels at mmdet's
    init scale (normal, std 0.01 and 0.001), in place. With every kernel at
    1/sqrt(fan_in) the deltas come out of order one, and `delta2bbox`
    turns the heads' ~1e-6 relative f32 differences into ~5e-3 px on
    anchors up to 512 px wide; at mmdet's scale they stay ~2e-4 px."""
    p = variables['params']
    for module, layer, std in (('rpn_head', 'rpn_reg', 0.01),
                               ('bbox_head', 'fc_reg', 0.001)):
        k = p[module][layer]['kernel']
        p[module][layer]['kernel'] = (rs.standard_normal(k.shape) *
                                      std).astype(np.float32)
    return variables


def _tiny_jax():
    cfg = jconfig.Config.fromfile(FPN_CFG)
    cfg.merge_from_dict(TINY)
    return jbuilder.build_detector(cfg.model)


def _tiny_port_cfg():
    cfg = tconfig.Config.fromfile(FPN_CFG)
    cfg.merge_from_dict(TINY)
    return cfg


@pytest.fixture(scope='module')
def tiny():
    """The JAX tiny FPN detector with numpy weights, and the port's built
    from the same config and loaded from them (every leaf maps)."""
    model = _tiny_jax()
    dummy = dict(image=jnp.zeros((2, 96, 160, 3)),
                 img_shape=jnp.full((2, 2), 96, jnp.int32))
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: model.init(
        {'params': k, 'sampler': k, 'dropout': k}, dummy, train=False))
    rs = np.random.RandomState(7)
    variables = regression_init(fill_variables(shapes, rs), rs)
    bundle = tapis.init_detector(_tiny_port_cfg(), variables=variables,
                                 device='cpu')
    return model, variables, bundle


def _images(seed=3):
    rs = np.random.RandomState(seed)
    image = rs.standard_normal((2, 96, 160, 3)).astype(np.float32)
    return image, np.array([[96, 160], [80, 128]], np.int32)


def test_rpn_flatten_and_anchors_match_jax(tiny):
    """P2–P6 of the trunk and neck, the RPN outputs flattened level by
    level (NHWC, location-major, anchor-minor) and the anchors over the
    five strides, against the JAX package's `_flat_rpn`."""
    model, variables, bundle = tiny
    image, _ = _images()
    jfeats, jcls, jreg, janchors = model.apply(
        variables, jnp.asarray(image), method=lambda m, x: m._flat_rpn(x))
    tm = bundle.model
    with torch.no_grad():
        feats = tm.extract_feat(torch.from_numpy(image))
        cls, reg, anchors = tm.rpn_outputs(feats)
    assert len(feats) == len(jfeats) == 5
    for g, r in zip(feats, jfeats):
        assert tuple(g.shape) == _nchw(r).shape
        _close_scaled(g.numpy(), _nchw(r))
    n = 3 * sum(f.shape[-2] * f.shape[-1] for f in feats)
    assert cls.shape == (2, n, 1, 1) and reg.shape == (2, n, 1, 4)
    np.testing.assert_array_equal(anchors.numpy(), np.asarray(janchors))
    _close_scaled(cls.numpy().reshape(2, n), np.asarray(jcls))
    _close_scaled(reg.numpy().reshape(2, n, 4), np.asarray(jreg))


def test_predict_matches(tiny):
    model, variables, bundle = tiny
    image, img_shape = _images()
    ref = jax.jit(lambda v, bt: model.apply(v, bt, train=False))(
        variables, dict(image=jnp.asarray(image),
                        img_shape=jnp.asarray(img_shape)))
    got = bundle.model.predict(dict(image=torch.from_numpy(image),
                                    img_shape=torch.from_numpy(img_shape)))
    valid = np.asarray(ref['valid'])
    assert valid.sum() >= 20
    np.testing.assert_array_equal(got['valid'].numpy(), valid)
    np.testing.assert_array_equal(got['labels'].numpy(),
                                  np.asarray(ref['labels']))
    np.testing.assert_allclose(got['dets'].numpy(), np.asarray(ref['dets']),
                               atol=1e-3)


def test_converter_maps_every_leaf_at_full_width():
    """The full-width Cityscapes FPN config (R50, 256-channel neck, 8
    classes): every leaf of the JAX variable tree maps onto the port's
    detector and covers its state dict. `init_detector` reads the canvas
    only from a `MultiScaleFlipAug` test step, as the JAX package does, so
    this config gets the default (1000, 600) → 608x1024."""
    model = jbuilder.build_detector(jconfig.Config.fromfile(FPN_CFG).model)
    dummy = dict(image=jnp.zeros((1, 64, 64, 3)),
                 img_shape=jnp.full((1, 2), 64, jnp.int32))
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: model.init(
        {'params': k, 'sampler': k, 'dropout': k}, dummy, train=False))
    tree = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), shapes)
    bundle = tapis.init_detector(FPN_CFG, device='cpu', seed=0)
    state, unmapped = convert.from_jax_variables(tree, bundle.model)
    assert unmapped == []
    assert set(state) == set(bundle.model.state_dict())
    assert bundle.canvas == (608, 1024) and bundle.img_scale == (1000, 600)
    assert any(k.startswith('neck.lateral_3.') for k in state)
    n = sum(p.numel() for p in bundle.model.parameters())
    assert n == sum(int(np.prod(s.shape)) for s in
                    jax.tree_util.tree_leaves(shapes['params']))


@pytest.mark.parametrize('override,match', [
    ({'dtype': 'float16'}, 'float32'),
    ({'neck_type': 'PAFPN'}, 'PAFPN'),
    ({'backbone_cfg': dict(type='ResNeXt')}, 'ResNet'),
    ({'roi_layer': 'dpool'}, 'roi_layer'),
    ({'roi_extractor_type': 'groie_concat'}, 'groie'),
    ({'roi_train_cfg': dict(sampler_type='ohem')}, 'ohem'),
])
def test_builder_refuses_what_is_not_ported(override, match):
    cfg = dict(type='FasterRCNNFPN', num_classes=8, **override)
    with pytest.raises(NotImplementedError, match=match):
        tbuilder.build_detector(cfg, device='meta')


def test_builder_reads_flat_sub_configs_as_the_jax_builder():
    cfg = dict(type='FasterRCNNFPN', num_classes=3, backbone_depth=18,
               rpn_proposal_cfg=dict(nms_pre=512, max_per_img=64),
               roi_train_cfg=dict(num_samples=32, target_stds=[1, 1, 1, 1]),
               dtype='float32')
    got = tbuilder.build_detector(cfg, device='meta')
    ref = jbuilder.build_detector(dict(cfg, dtype=jnp.float32))
    assert got.rpn_proposal_cfg._asdict() == ref.rpn_proposal_cfg._asdict()
    assert got.roi_train_cfg._asdict() == ref.roi_train_cfg._asdict()
    assert got.rpn_strides == tuple(ref.rpn_strides)


def test_random_init_gives_the_heads_mmdet_scales():
    """Without a checkpoint the RPN's convs and the box head's classifier
    and regressor get mmdet's normal init (std 0.01, 0.01, 0.001), the rest
    flax's 1/sqrt(fan_in): at that scale the heads' deltas are of order one
    and the FPN config's lr of 0.01 diverges."""
    model = tapis.init_detector(_tiny_port_cfg(), device='cpu', seed=1).model
    for w, std in ((model.rpn_head.rpn_conv.weight, 0.01),
                   (model.rpn_head.rpn_reg.weight, 0.01),
                   (model.bbox_head.fc_cls.weight, 0.01),
                   (model.bbox_head.fc_reg.weight, 0.001),
                   (model.neck.fpn_conv_0.weight, 1 / 24.0),
                   (model.bbox_head.shared_fc1.weight, 1 / 56.0)):
        got = float(w.detach().std())
        assert abs(got / std - 1) < 0.05, (tuple(w.shape), got, std)
