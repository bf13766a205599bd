"""The mask slice against the JAX package: the FCN mask head (plain and
normed predictor), its 2x bilinear resize at the edges, the box-frame mask
targets, the mask loss, `PackDetInputs(with_mask=True)`, `paste_masks`,
`predict` of tiny `MaskRCNN` (the Cityscapes mask config with an R18
trunk, a 64-channel neck and 2 classes) and `MaskRCNNC4` (the C4 config
with an R18 trunk and 2 classes), the weight converter on both full-width
configs, and the builder's refusals.

Weights and inputs come from numpy seeds; weights carry across by
`from_jax_variables`. Tolerances: heads, targets and loss within 1e-5 of
the output's scale (the same f32 arithmetic in another order); the resize
within 1e-6; detections within 1e-3 with labels and validity identical;
mask probabilities within 1e-4; pasted masks equal except where PIL's
resized value sits on the 127.5 threshold (127 or 128).
"""

import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from .test_torch_fpn import TINY, regression_init
from .torch_port_utils import JAX_PKG, PORT_PKG, fill_variables

ROOT = pathlib.Path(__file__).resolve().parent.parent
MASK_CFG = str(ROOT / 'configs/cityscapes/mask_rcnn_r50_fpn_1x_cityscapes.py')
C4_CFG = str(ROOT / 'configs/mask_rcnn/mask_rcnn_r50_caffe_c4_1x.py')
C4_TINY = {'model.backbone_depth': 18, 'model.num_classes': 2}

jmask = importlib.import_module(f'{JAX_PKG}.models.roi_heads.mask_head')
jmrcnn = importlib.import_module(f'{JAX_PKG}.models.detectors.mask_rcnn')
jtransforms = importlib.import_module(f'{JAX_PKG}.data.pipelines.transforms')
jbuilder = importlib.import_module(f'{JAX_PKG}.models.builder')
jconfig = importlib.import_module(f'{JAX_PKG}.utils.config')
tmask = importlib.import_module(f'{PORT_PKG}.models.roi_heads.mask_head')
tmrcnn = importlib.import_module(f'{PORT_PKG}.models.detectors.mask_rcnn')
ttransforms = importlib.import_module(f'{PORT_PKG}.data.pipelines.transforms')
tdata = importlib.import_module(f'{PORT_PKG}.data')
tbuilder = importlib.import_module(f'{PORT_PKG}.models.builder')
tconfig = importlib.import_module(f'{PORT_PKG}.utils.config')
tapis = importlib.import_module(f'{PORT_PKG}.apis.inference')
convert = importlib.import_module(f'{PORT_PKG}.utils.convert')


def _close_scaled(got, ref, tol=1e-5):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=tol * scale)


@pytest.mark.parametrize('normed', [False, True])
@pytest.mark.parametrize('num_convs,s', [(4, 7), (0, 7), (4, 14)])
def test_fcn_mask_head_matches_jax(normed, num_convs, s):
    """(B, R, s, s, C) NHWC RoI features → (B, R, 2s, 2s, K) logits."""
    rs = np.random.RandomState(s + num_convs + normed)
    x = rs.standard_normal((2, 5, s, s, 12)).astype(np.float32)
    jm = jmask.FCNMaskHead(num_classes=3, num_convs=num_convs,
                           feat_channels=16, normed_predictor=normed)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x))
    variables = fill_variables(shapes, rs)
    ref = jm.apply(variables, jnp.asarray(x))
    tm = tmask.FCNMaskHead(num_classes=3, num_convs=num_convs,
                           in_channels=12, feat_channels=16,
                           normed_predictor=normed)
    convert.load_jax_variables(tm, variables)
    got = tm(torch.from_numpy(x)).detach()
    assert tuple(got.shape) == ref.shape == (2, 5, 2 * s, 2 * s, 3)
    _close_scaled(got.numpy(), ref)


@pytest.mark.parametrize('s', [7, 14])
def test_bilinear_2x_resize_matches_jax_at_the_edges(s):
    """`jax.image.resize(..., 'bilinear')` at 2x equals `F.interpolate`
    with half-pixel centres, no corner alignment and no antialiasing, edges
    included: the JAX kernel renormalises its in-bounds taps where torch
    clamps the source coordinate, and both make the outermost output rows
    (columns) the input's edge rows (columns) resized along the other axis
    alone."""
    rs = np.random.RandomState(s)
    x = rs.standard_normal((3, 4, s, s)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (3, 4, 2 * s, 2 * s),
                                      method='bilinear'))
    got = F.interpolate(torch.from_numpy(x), scale_factor=2, mode='bilinear',
                        align_corners=False, antialias=False).numpy()
    _close_scaled(got, ref, 1e-6)
    # the edge rows are the edge input rows resized along x alone (and the
    # columns likewise), so the corners are the input's corners
    for edge in (0, -1):
        row = x[..., edge:edge + 1 or None, :]
        _close_scaled(got[..., edge, :], np.asarray(jax.image.resize(
            jnp.asarray(row), (3, 4, 1, 2 * s), method='bilinear'))[..., 0, :],
            1e-6)
        col = x[..., :, edge:edge + 1 or None]
        _close_scaled(got[..., :, edge], np.asarray(jax.image.resize(
            jnp.asarray(col), (3, 4, 2 * s, 1), method='bilinear'))[..., 0],
            1e-6)
        _close_scaled(got[..., edge, edge], x[..., edge, edge], 1e-6)


def _mask_target_inputs(rs, b=2, g=3, s=24, m=28):
    masks = (rs.uniform(0, 1, (b, g, m, m)) > 0.5).astype(np.uint8)
    xy = rs.uniform(0, 100, (b, g, 2))
    wh = rs.uniform(4, 60, (b, g, 2))
    gt = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    matched = rs.randint(0, g, (b, s)).astype(np.int32)
    box = np.take_along_axis(gt, matched[..., None], 1)
    bw = (box[..., 2:] - box[..., :2])
    # RoIs from inside their gt box to far beyond it (frame coordinates
    # about [-M, 2M]), some under a pixel of the raster
    lo = box[..., :2] + rs.uniform(-1.0, 1.0, (b, s, 2)) * bw
    size = bw * rs.uniform(0.005, 1.2, (b, s, 2))
    rois = np.concatenate([lo, lo + size], -1).astype(np.float32)
    rois[0, 0] = box[0, 0]                               # the gt box itself
    rois[0, 1] = [0, 0, 0, 0]                            # a padded slot
    return masks, gt, rois, matched


def test_mask_targets_match_jax():
    rs = np.random.RandomState(0)
    masks, gt, rois, matched = _mask_target_inputs(rs)
    ref = jmask.mask_targets_from_box_frame(
        jnp.asarray(masks), jnp.asarray(gt), jnp.asarray(rois),
        jnp.asarray(matched), 28)
    got = tmask.mask_targets_from_box_frame(
        torch.from_numpy(masks), torch.from_numpy(gt),
        torch.from_numpy(rois), torch.from_numpy(matched), 28)
    assert got.shape == (2, 24, 28, 28) and got.dtype == torch.float32
    _close_scaled(got.numpy(), ref)
    assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0


def _targets(raster, gt_boxes, rois, out_size=8):
    """The port's targets for one RoI, held to the JAX function's."""
    got = tmask.mask_targets_from_box_frame(
        torch.from_numpy(raster), torch.tensor(gt_boxes),
        torch.tensor(rois), torch.zeros((1, 1), dtype=torch.int32),
        out_size).numpy()[0, 0]
    ref = jmask.mask_targets_from_box_frame(
        jnp.asarray(raster), jnp.asarray(gt_boxes), jnp.asarray(rois),
        jnp.zeros((1, 1), jnp.int32), out_size)
    _close_scaled(got, np.asarray(ref)[0, 0])
    return got


def test_mask_targets_identity_and_half_crop():
    """The JAX package's own cases (`tests/test_models/test_mask_rcnn.py`):
    a RoI equal to its gt box reproduces the raster; one over the right
    half of the box sees only that half."""
    m = 16
    raster = np.zeros((1, 1, m, m), np.uint8)
    raster[..., :, :m // 2] = 1
    t = _targets(raster, [[[10., 10., 50., 30.]]], [[[10., 10., 50., 30.]]])
    assert t[:, :3].min() > 0.9 and t[:, 5:].max() < 0.1
    t = _targets(raster, [[[0., 0., 40., 40.]]], [[[20., 0., 40., 40.]]])
    assert t.max() < 0.2


def test_mask_loss_matches_jax():
    """Own-class BCE, positives weighted; background rows (label K) read
    class K - 1 at weight 0; the denominator max(Σ w · h · w, 1)."""
    rs = np.random.RandomState(1)
    logits = (3 * rs.standard_normal((2, 6, 8, 8, 3))).astype(np.float32)
    targets = rs.uniform(0, 1, (2, 6, 8, 8)).astype(np.float32)
    labels = rs.randint(0, 4, (2, 6)).astype(np.int32)
    for pos in ((labels < 3) & (rs.uniform(0, 1, (2, 6)) > 0.3),
                np.zeros((2, 6), bool)):
        pos_w = pos.astype(np.float32)
        ref = jmask.mask_loss(jnp.asarray(logits), jnp.asarray(targets),
                              jnp.asarray(labels), jnp.asarray(pos_w))
        got = tmask.mask_loss(torch.from_numpy(logits),
                              torch.from_numpy(targets),
                              torch.from_numpy(labels),
                              torch.from_numpy(pos_w))
        np.testing.assert_allclose(float(got['loss_mask']),
                                   float(ref['loss_mask']), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize('n_gt,msize', [(3, 56), (0, None), (12, 28)])
def test_pack_det_inputs_with_mask_matches_jax(n_gt, msize):
    """`gt_masks` (max_gt, M, M) uint8, zero-padded, M from the rasters
    (112 without any); more gts than `max_gt` are cut; collate stacks."""
    rs = np.random.RandomState(n_gt)
    img = rs.randint(0, 256, (32, 48, 3)).astype(np.float32)
    results = dict(img_shape=(32, 48), ori_shape=(32, 48),
                   gt_bboxes=rs.uniform(0, 30, (n_gt, 4)).astype(np.float32),
                   gt_labels=rs.randint(0, 3, (n_gt,)).astype(np.int64))
    if msize:
        results['gt_masks'] = rs.randint(0, 2, (n_gt, msize, msize)).astype(
            np.uint8)
    ref = jtransforms.PackDetInputs(max_gt=10, with_mask=True)(
        dict(results, img=img))
    got = ttransforms.PackDetInputs(max_gt=10, with_mask=True)(
        dict(results, img=torch.from_numpy(img)))
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)
        assert np.asarray(got[k]).dtype == v.dtype, k
    batch = tdata.collate([got, got])
    assert batch['gt_masks'].shape == (2, 10, msize or 112, msize or 112)
    assert batch['gt_masks'].dtype == torch.uint8


def test_paste_masks_matches_jax():
    """Boxes up- and downscaling the 28x28 masks, crossing and beyond the
    image, under a pixel and zero-size (padded)."""
    from PIL import Image
    rs = np.random.RandomState(2)
    d, m, ih, iw = 40, 28, 96, 128
    masks = rs.uniform(0, 1, (d, m, m)).astype(np.float32)
    masks[:10] = np.clip(rs.standard_normal((10, m, m)) * 0.02 + 0.5, 0, 1)
    xy = rs.uniform(-30, 120, (d, 2))
    wh = np.exp(rs.uniform(np.log(0.4), np.log(120), (d, 2)))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[0] = [0, 0, 0, 0]
    boxes[1] = [130, 100, 160, 140]
    boxes[2] = [-5.4, -7.6, 140.2, 99.5]
    ref = jmrcnn.paste_masks(masks, boxes, ih, iw)
    got = tmrcnn.paste_masks(torch.from_numpy(masks), torch.from_numpy(boxes),
                             ih, iw)
    assert got.dtype == torch.bool and tuple(got.shape) == ref.shape
    assert ref.sum() > 1000
    for i in np.flatnonzero((got.numpy() != ref).any(axis=(1, 2))):
        x1, y1, x2, y2 = [int(round(v)) for v in boxes[i]]
        pil = np.asarray(Image.fromarray((masks[i] * 255).astype(np.uint8))
                         .resize((max(x2 - x1, 1), max(y2 - y1, 1)),
                                 Image.BILINEAR))
        ys, xs = np.nonzero(got[i].numpy() != ref[i])
        assert np.isin(pil[ys - y1, xs - x1], (127, 128)).all(), i


def _jax_variables(model, image_hw, seed):
    dummy = dict(image=jnp.zeros((2, *image_hw, 3)),
                 img_shape=jnp.full((2, 2), image_hw[0], jnp.int32))
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: model.init(
        {'params': k, 'sampler': k, 'dropout': k}, dummy, train=False))
    rs = np.random.RandomState(seed)
    return regression_init(fill_variables(shapes, rs), rs)


def _tiny(path, overrides, seed):
    jcfg = jconfig.Config.fromfile(path)
    jcfg.merge_from_dict(overrides)
    model = jbuilder.build_detector(jcfg.model)
    variables = _jax_variables(model, (96, 160), seed)
    cfg = tconfig.Config.fromfile(path)
    cfg.merge_from_dict(overrides)
    bundle = tapis.init_detector(cfg, variables=variables, device='cpu')
    return model, variables, bundle


# 40 proposals an image: fewer detections than the 100 rows, so padded
# (zero-area) rows reach the mask branch
FEW = {'model.rpn_test_cfg': dict(max_per_img=40)}


@pytest.mark.parametrize('path,overrides,seed,mask_size', [
    (MASK_CFG, TINY, 7, 28), (C4_CFG, C4_TINY, 3, 14)])
def test_tiny_predict_matches_jax(path, overrides, seed, mask_size):
    """Labels and validity identical, dets within 1e-3 and the masks of
    every detection row, padded ones included, within 1e-4."""
    model, variables, bundle = _tiny(path, dict(overrides, **FEW), seed)
    rs = np.random.RandomState(3)
    image = rs.standard_normal((2, 96, 160, 3)).astype(np.float32)
    img_shape = np.array([[96, 160], [80, 128]], np.int32)
    ref = jax.jit(lambda v, bt: model.apply(v, bt, train=False))(
        variables, dict(image=jnp.asarray(image),
                        img_shape=jnp.asarray(img_shape)))
    got = bundle.model.predict(dict(image=torch.from_numpy(image),
                                    img_shape=torch.from_numpy(img_shape)))
    valid = np.asarray(ref['valid'])
    assert valid.sum() >= 20 and not valid.all()
    np.testing.assert_array_equal(got['valid'].numpy(), valid)
    np.testing.assert_array_equal(got['labels'].numpy(),
                                  np.asarray(ref['labels']))
    np.testing.assert_allclose(got['dets'].numpy(), np.asarray(ref['dets']),
                               atol=1e-3)
    assert got['masks'].shape == (2, 100, mask_size, mask_size)
    np.testing.assert_allclose(got['masks'].numpy(), np.asarray(ref['masks']),
                               rtol=0, atol=1e-4)


def _full_width_tree(path, **model_overrides):
    cfg = jconfig.Config.fromfile(path)
    model = jbuilder.build_detector(dict(cfg.model, **model_overrides))
    dummy = dict(image=jnp.zeros((1, 64, 64, 3)),
                 img_shape=jnp.full((1, 2), 64, jnp.int32))
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: model.init(
        {'params': k, 'sampler': k, 'dropout': k}, dummy, train=False))
    return shapes, jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), shapes)


@pytest.mark.parametrize('path,overrides,prefixes', [
    (MASK_CFG, {}, ('mask_head.conv3.', 'mask_head.conv_logits.')),
    (MASK_CFG, {'normed_mask': True}, ('mask_head.conv_logits_kernel',)),
    (C4_CFG, {}, ('shared_head.res5_block2.bn3.', 'bbox_head.fc_cls.',
                  'mask_head.upsample_conv.')),
])
def test_converter_maps_every_leaf_at_full_width(path, overrides, prefixes):
    """Every leaf of the full-width JAX tree maps onto the port's detector
    and covers its state dict: the mask head's convs and logits (or the
    normed kernel), C4's shared res5 blocks with their frozen BN and its
    pooled box head."""
    shapes, tree = _full_width_tree(path, **overrides)
    cfg = tconfig.Config.fromfile(path)
    cfg.merge_from_dict({f'model.{k}': v for k, v in overrides.items()})
    model = tbuilder.build_detector(cfg.model, device='cpu')
    state, unmapped = convert.from_jax_variables(tree, model)
    assert unmapped == []
    assert set(state) == set(model.state_dict())
    for p in prefixes:
        assert any(k.startswith(p) for k in state), p
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(int(np.prod(s.shape)) for s in
                    jax.tree_util.tree_leaves(shapes['params']))


@pytest.mark.parametrize('det_type,override,match', [
    ('MaskRCNN', {'loss_cls': 'seesaw'}, 'softmax'),
    ('MaskRCNN', {'roi_extractor_type': 'groie_concat'}, 'groie'),
    ('MaskRCNN', {'neck_type': 'PAFPN'}, 'PAFPN'),
    ('MaskRCNN', {'backbone_cfg': dict(type='ResNeXt')}, 'ResNet'),
    ('MaskRCNN', {'roi_layer': 'dpool'}, 'roi_layer'),
    ('MaskRCNN', {'roi_train_cfg': dict(sampler_type='ohem')}, 'ohem'),
    ('MaskRCNN', {'dtype': 'float16'}, 'float32'),
    ('MaskRCNNC4', {'backbone_cfg': dict(type='ResNeXt')}, 'ResNet'),
    ('MaskRCNNC4', {'roi_train_cfg': dict(sampler_type='ohem')}, 'ohem'),
])
def test_builder_refuses_what_is_not_ported(det_type, override, match):
    cfg = dict(type=det_type, num_classes=8, **override)
    with pytest.raises(NotImplementedError, match=match):
        tbuilder.build_detector(cfg, device='meta')


def test_builder_reads_sub_configs_through_the_subclass():
    """MaskRCNN's FPN options reach `FasterRCNNFPN` through **kwargs; a
    dict for a NamedTuple field still merges over its default, as the JAX
    builder does."""
    cfg = dict(type='MaskRCNN', num_classes=3, backbone_depth=18,
               rpn_proposal_cfg=dict(nms_pre=512, max_per_img=64),
               roi_train_cfg=dict(num_samples=32), mask_size=14)
    got = tbuilder.build_detector(cfg, device='meta')
    ref = jbuilder.build_detector(dict(cfg))
    assert got.rpn_proposal_cfg._asdict() == ref.rpn_proposal_cfg._asdict()
    assert got.roi_train_cfg._asdict() == ref.roi_train_cfg._asdict()
    assert got.mask_size == ref.mask_size == 14
