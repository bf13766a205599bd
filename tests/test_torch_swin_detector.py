"""The Swin detectors in the port against the JAX package: `predict` of a
tiny Swin `MaskRCNN` built through `backbone_cfg`, the weight converter on
the three full-width Swin configurations (DeepAlign-Swin, Mask R-CNN
Swin-T 1x and its bf16 ms-crop variant), and the builder's routes to the
trunk (nested `trunk_type`, flat `backbone_cfg`, the keys it drops and
what still raises).

Weights and inputs come from numpy seeds and are carried across with
`from_jax_variables`. Tolerances as `test_torch_mask.py`: labels and
validity identical, detections within 1e-3, mask probabilities within
1e-4.
"""

import importlib
import pathlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .test_torch_mask import FEW, _tiny
from .torch_port_utils import JAX_PKG, PORT_PKG

ROOT = pathlib.Path(__file__).resolve().parent.parent
DA_SWIN = 'configs/da/deepalign_swin_t_c2f.py'
MASK_1X = 'configs/swin/mask_rcnn_swin-t-p4-w7_fpn_1x.py'
MASK_BF16 = 'configs/swin/mask_rcnn_swin-t-p4-w7_fpn_fp16_ms-crop-3x.py'
TINY_SWIN = dict(type='SwinTransformer', embed_dims=16, depths=(2, 2, 2, 2),
                 num_heads=(1, 2, 2, 4))

jbuilder = importlib.import_module(f'{JAX_PKG}.models.builder')
jconfig = importlib.import_module(f'{JAX_PKG}.utils.config')
tbuilder = importlib.import_module(f'{PORT_PKG}.models.builder')
tconfig = importlib.import_module(f'{PORT_PKG}.utils.config')
tswin = importlib.import_module(f'{PORT_PKG}.models.backbones.swin')
convert = importlib.import_module(f'{PORT_PKG}.utils.convert')


def test_tiny_swin_mask_rcnn_predict_matches_jax():
    """The 1x Swin config with a tiny Swin (embed 16, windows padded at
    every stage of the 96x160 canvas), a 16-channel neck and 2 classes,
    through `backbone_cfg` on both sides."""
    overrides = dict(FEW, **{'model.backbone_cfg': TINY_SWIN,
                             'model.neck_channels': 16,
                             'model.num_classes': 2})
    model, variables, bundle = _tiny(str(ROOT / MASK_1X), overrides, 5)
    assert isinstance(bundle.model.backbone, tswin.SwinTransformer)
    rs = np.random.RandomState(3)
    image = rs.standard_normal((2, 96, 160, 3)).astype(np.float32)
    img_shape = np.array([[96, 160], [80, 128]], np.int32)
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
    np.testing.assert_allclose(got['masks'].numpy(), np.asarray(ref['masks']),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize('path', [DA_SWIN, MASK_1X, MASK_BF16])
def test_converter_maps_every_leaf_at_full_width(path):
    """Every leaf of the full-width JAX variable tree (`jax.eval_shape`,
    no compute) maps onto the port's detector with its shape, none is left
    over and the port has no parameter the JAX tree lacks: Swin-T's 32
    LayerNorms, window attention (`rel_bias` 169 x heads), MLPs and
    bias-free merges, and on DeepAlign-Swin the RPN conv and the first
    box-head FC at the tapped stage's 384 channels."""
    cfg = tconfig.Config.fromfile(str(ROOT / path))
    jcfg = jconfig.Config.fromfile(str(ROOT / path))
    model = jbuilder.build_detector(jcfg.model)
    da = path == DA_SWIN
    b = 2 if da else 1
    dummy = dict(image=jnp.zeros((b, 64, 96, 3)),
                 img_shape=jnp.full((b, 2), 64, jnp.int32))
    if da:
        dummy.update(gt_bboxes=jnp.zeros((b, 4, 4)),
                     gt_labels=jnp.zeros((b, 4), jnp.int32),
                     gt_valid=jnp.zeros((b, 4), bool),
                     domain=jnp.array([0, 1], jnp.int32))
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: model.init(
        {'params': k, 'sampler': k, 'dropout': k}, dummy, train=da))
    tree = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), shapes)
    port = tbuilder.build_detector(cfg.model, device='meta',
                                   canvas=tbuilder.train_canvas(cfg))
    state, unmapped = convert.from_jax_variables(tree, port)
    assert unmapped == []
    target = port.state_dict()
    assert set(state) == set(target)
    for key, v in state.items():
        assert tuple(v.shape) == tuple(target[key].shape), key
    trunk = port.backbone.trunk if da else port.backbone
    assert isinstance(trunk, tswin.SwinTransformer)
    assert sum(isinstance(m, tswin.LayerNorm) for m in trunk.modules()) == 32
    assert tuple(target[next(k for k in target if k.endswith(
        'stage2.block5.attn.rel_bias'))].shape) == (169, 12)
    if da:
        assert tuple(target['rpn_head.rpn_conv.weight'].shape) == \
            (2048, 384, 3, 3)
        assert tuple(target['bbox_head.shared_fc1.weight'].shape) == \
            (1024, 384 * 49)
        assert port.anchor_cfg.stride == port.featmap_stride == 16
    else:
        assert [tuple(target[f'neck.lateral_{i}.weight'].shape)[1]
                for i in range(4)] == [96, 192, 384, 768]


def test_builder_routes_the_swin_trunk():
    """Nested: `trunk_type='swin'` and a `SwinTransformer` backbone type
    set the trunk, and the feature and anchor stride from `out_stride`
    (default 32); a detector with no Swin route raises. Flat: the config's
    keys under the detector's defaults, the torch-only ones dropped
    silently, the rest that Swin lacks with JAX's warning; another trunk
    type still raises."""
    nested = dict(type='DAFasterRCNN_Deep',
                  backbone=dict(type='SwinTransformer'),
                  rpn_head=dict(anchor_generator=dict(strides=[16])))
    kwargs = tbuilder._nested_to_kwargs(nested)
    assert kwargs['backbone_type'] == 'swin'
    assert kwargs['featmap_stride'] == kwargs['anchor_cfg'].stride == 32
    assert tbuilder._nested_to_kwargs(dict(
        type='DAFasterRCNN_Deep', backbone=dict(
            type='DAResNet', trunk_type='swin', out_stride=16)))[
        'featmap_stride'] == 16
    with pytest.raises(NotImplementedError, match='ResNet trunk only'):
        tbuilder.build_detector(dict(type='FasterRCNN', backbone=dict(
            type='SwinTransformer')), device='meta')
    with pytest.raises(NotImplementedError, match='ResNet trunk only'):
        tbuilder.build_detector(dict(type='FasterRCNN',
                                     backbone_cfg=TINY_SWIN), device='meta')
    backbone_cfg = dict(TINY_SWIN, init_cfg=dict(type='Pretrained'),
                        convert_weights=True, mlp_ratio=4, with_cp=False,
                        frozen_stages=2, out_indices=[1, 2, 3])
    with warnings.catch_warnings(record=True) as record:
        warnings.simplefilter('always')
        model = tbuilder.build_detector(dict(
            type='MaskRCNN', num_classes=2, backbone_cfg=backbone_cfg),
            device='meta')
    messages = [str(r.message) for r in record]
    assert messages == ["SwinTransformer: ignoring backbone config keys "
                        "['mlp_ratio']"]
    trunk = model.backbone
    assert (trunk.embed_dims, trunk.depths, trunk.frozen_stages,
            trunk.out_indices) == (16, (2, 2, 2, 2), 2, (1, 2, 3))
    with pytest.raises(NotImplementedError, match='SwinTransformer'):
        tbuilder.build_detector(dict(type='MaskRCNN', backbone_cfg=dict(
            type='PyramidVisionTransformer')), device='meta')
