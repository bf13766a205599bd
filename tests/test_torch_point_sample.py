"""The pieces the RoI-head variants share, against the JAX package:
`ops/point_sample.py`, flax's `GroupNorm` (port `models/layers/norm.py:
GroupNorm`), GRoIE (`extract_roi_feats_groie`, forward and gradient) and
`roi_head_predict(with_reg=False)`; on seeded numpy inputs.

Tolerances: point sampling within 1e-6; the norm within 1e-5 at f32 and,
for a bf16 input, within 2e-2 of the output's scale; GRoIE within 1e-5 of
scale (its gradient too); detections within 1e-3 with labels and validity
identical.
"""

import importlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .torch_port_utils import JAX_PKG, PORT_PKG, fill_variables

jps = importlib.import_module(f'{JAX_PKG}.ops.point_sample')
jroi = importlib.import_module(f'{JAX_PKG}.models.roi_heads.standard_roi_head')
jbbox = importlib.import_module(f'{JAX_PKG}.models.roi_heads.bbox_head')
tps = importlib.import_module(f'{PORT_PKG}.ops.point_sample')
tnorm = importlib.import_module(f'{PORT_PKG}.models.layers.norm')
troi = importlib.import_module(f'{PORT_PKG}.models.roi_heads.standard_roi_head')
tbbox = importlib.import_module(f'{PORT_PKG}.models.roi_heads.bbox_head')
convert = importlib.import_module(f'{PORT_PKG}.utils.convert')


def _points(rs, b, p):
    """(b, p, 2) normalized points, a third of them past an edge (down to
    -0.3 and up to 1.3), and the corners and edges exactly."""
    pts = rs.uniform(-0.3, 1.3, (b, p, 2))
    pts[:, :6] = [[0, 0], [1, 1], [0, 1], [1, 0], [0.5, 0], [1, 0.5]]
    return pts.astype(np.float32)


@pytest.mark.parametrize('align_corners', [False, True])
def test_point_sample_matches(align_corners):
    rs = np.random.RandomState(0)
    feats = rs.standard_normal((2, 7, 9, 5)).astype(np.float32)
    pts = _points(rs, 2, 64)
    ref = jps.batched_point_sample(jnp.asarray(feats), jnp.asarray(pts),
                                   align_corners)
    got = tps.batched_point_sample(torch.from_numpy(feats),
                                   torch.from_numpy(pts), align_corners)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    one = tps.point_sample(torch.from_numpy(feats[1]),
                           torch.from_numpy(pts[1]), align_corners)
    np.testing.assert_array_equal(one.numpy(), got[1].numpy())
    outside = (pts < -1.0 / 7).any(-1) | (pts > 1 + 1.0 / 7).any(-1)
    if not align_corners:           # wholly past an edge: zero padding
        assert outside.any() and not got.numpy()[outside].any()


def test_point_sample_of_bf16_features_is_f32():
    """A bf16 map is read at bf16 and weighted in f32, as JAX promotes."""
    rs = np.random.RandomState(1)
    feats = rs.standard_normal((1, 6, 6, 4)).astype(np.float32)
    pts = _points(rs, 1, 32)
    ref = jps.batched_point_sample(jnp.asarray(feats, jnp.bfloat16),
                                   jnp.asarray(pts))
    got = tps.batched_point_sample(torch.from_numpy(feats).bfloat16(),
                                   torch.from_numpy(pts))
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


def test_rel_roi_point_to_rel_img_point_matches():
    rs = np.random.RandomState(2)
    rois = np.sort(rs.uniform(0, 60, (5, 2, 2)), 1).reshape(5, 4)[:, [0, 2, 1, 3]]
    rois = rois.astype(np.float32)
    rel = rs.uniform(0, 1, (7, 2)).astype(np.float32)
    ref = jps.rel_roi_point_to_rel_img_point(jnp.asarray(rois),
                                             jnp.asarray(rel), (16, 24), 0.25)
    got = tps.rel_roi_point_to_rel_img_point(torch.from_numpy(rois),
                                             torch.from_numpy(rel), (16, 24),
                                             0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)


# ---- GroupNorm -------------------------------------------------------------

GN_CASES = {  # name: (input shape NHWC-style, flax kwargs, port kwargs)
    'grid_rois': ((2, 5, 6, 6, 16), dict(num_groups=8),
                  dict(num_groups=8, channel_dim=2)),
    'image': ((2, 7, 9, 12), dict(num_groups=4), dict(num_groups=4)),
    'instance': ((2, 7, 9, 12), dict(num_groups=None, group_size=1),
                 dict(group_size=1))}


def _gn_pair(name, dtype, seed=3):
    shape, jkw, tkw = GN_CASES[name]
    rs = np.random.RandomState(seed)
    x = (rs.standard_normal(shape) * 2 + 0.7).astype(np.float32)
    jm = fnn.GroupNorm(**jkw)
    variables = {'params': {
        'scale': rs.uniform(0.5, 1.5, shape[-1]).astype(np.float32),
        'bias': (0.1 * rs.standard_normal(shape[-1])).astype(np.float32)}}
    ref = np.asarray(jm.apply(variables, jnp.asarray(x, dtype)))
    tm = tnorm.GroupNorm(shape[-1], **tkw)
    assert convert.load_jax_variables(tm, variables) == []
    tx = torch.from_numpy(x).to(getattr(torch, jnp.dtype(dtype).name))
    # channels at `channel_dim` (1 by default): NHWC → the port's layout
    cd = tkw.get('channel_dim', 1)
    perm = list(range(x.ndim))
    perm.insert(cd, perm.pop(-1))
    with torch.no_grad():
        got = tm(tx.permute(*perm))
    inv = np.argsort(perm)
    return got.permute(*inv).float().numpy(), ref, got.dtype


@pytest.mark.parametrize('name', sorted(GN_CASES))
def test_group_norm_matches_flax(name):
    """flax's statistics: every dim but the first and the channels (so a
    (B, S, h, w, C) RoI stack per image over its S RoIs), the fast
    variance, ε 1e-6."""
    got, ref, dtype = _gn_pair(name, jnp.float32)
    assert dtype == torch.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize('name', sorted(GN_CASES))
def test_group_norm_of_a_bf16_input_is_f32(name):
    """Like flax's module without a `dtype`, a bf16 input gives f32, within
    2e-2 of the output's scale of JAX's."""
    got, ref, dtype = _gn_pair(name, jnp.bfloat16)
    assert dtype == torch.float32 and ref.dtype == np.float32
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-2 * scale)


def test_group_norm_refuses_groups_that_do_not_divide():
    with pytest.raises(ValueError, match='divide'):
        tnorm.GroupNorm(12, num_groups=5)
    with pytest.raises(ValueError, match='one of'):
        tnorm.GroupNorm(12, num_groups=4, group_size=3)
    assert tnorm.InstanceNorm(6).num_groups == 6


# ---- GRoIE -----------------------------------------------------------------

def _pyramid(rs, b, c, hw=(32, 48)):
    return [rs.standard_normal((b, hw[0] // 2**i, hw[1] // 2**i, c)
                               ).astype(np.float32) for i in range(4)]


@pytest.mark.parametrize('out_size,flatten', [(7, True), (7, False),
                                              (14, False)])
def test_groie_matches_jax(out_size, flatten):
    """Every RoI pooled from all four levels and summed, as the JAX
    `extract_roi_feats_groie` (which returns (B, R, o, o, C); the port's
    `flatten` gives the x-major flat form of the same sum); and its
    gradient into each level."""
    rs = np.random.RandomState(4)
    b, c, n = 2, 8, 24
    feats = _pyramid(rs, b, c)
    xy = rs.uniform(-20, 170, (b, n, 2))
    wh = rs.uniform(1, 120, (b, n, 2))
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    rois[:, 0] = 0                                       # a padded row
    jf = [jnp.asarray(f) for f in feats]
    ref, vjp = jax.vjp(lambda *fs: jroi.extract_roi_feats_groie(
        fs, jnp.asarray(rois), out_size=out_size), *jf)
    ref = np.asarray(ref)
    cot = rs.standard_normal(ref.shape).astype(np.float32)
    ref_g = vjp(jnp.asarray(cot))
    tf = [torch.from_numpy(f).requires_grad_() for f in feats]
    got = troi.extract_roi_feats_groie(tf, torch.from_numpy(rois),
                                       out_size=out_size, flatten=flatten)
    want = ref.transpose(0, 1, 3, 2, 4).reshape(b, n, -1) if flatten else ref
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * scale)
    tcot = cot.transpose(0, 1, 3, 2, 4).reshape(b, n, -1) if flatten else cot
    grads = torch.autograd.grad(got, tf, torch.from_numpy(tcot))
    for i, (g, r) in enumerate(zip(grads, ref_g)):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-5 * float(np.abs(r).max()),
                                   err_msg=f'level {i}')


# ---- roi_head_predict(with_reg=False) --------------------------------------

def test_roi_head_predict_without_regression_matches():
    """`with_reg=False` scores the proposals themselves (the head's deltas
    are not decoded), as JAX's, through a multi-level extractor."""
    rs = np.random.RandomState(5)
    b, c, p, k = 2, 8, 40, 3
    feats = _pyramid(rs, b, c)
    xy = rs.uniform(0, 120, (b, p, 2))
    wh = rs.uniform(4, 60, (b, p, 2))
    props = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    prop_valid = rs.rand(b, p) > 0.2
    props *= prop_valid[..., None]
    img_shape = np.array([[128, 192], [100, 150]], np.int32)
    jm = jbbox.Shared2FCBBoxHead(num_classes=k, fc_out_channels=32)
    tm = tbbox.Shared2FCBBoxHead(num_classes=k, in_channels=c,
                                 fc_out_channels=32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((b, p, 7 * 7 * c))))
    variables = fill_variables(shapes, np.random.RandomState(6))
    assert convert.load_jax_variables(tm, variables) == []
    jcfg = jroi.RoITestConfig(max_per_img=20)
    ref = jroi.roi_head_predict(
        lambda f: jm.apply(variables, f), [jnp.asarray(f) for f in feats],
        jnp.asarray(props), jnp.asarray(prop_valid), jnp.asarray(img_shape),
        k, use_sigmoid_cls=False, cfg=jcfg,
        roi_extractor=lambda f, r: jroi.extract_roi_feats_fpn(f, r),
        with_reg=False)
    with torch.no_grad():
        got = troi.roi_head_predict(
            tm, [torch.from_numpy(f) for f in feats], torch.from_numpy(props),
            torch.from_numpy(prop_valid), torch.from_numpy(img_shape), k,
            use_sigmoid_cls=False, cfg=troi.RoITestConfig(max_per_img=20),
            roi_extractor=lambda f, r: troi.extract_roi_feats_fpn(
                f, r, flatten=True),
            with_reg=False)
    valid = np.asarray(ref['valid'])
    assert valid.sum() > 10
    np.testing.assert_array_equal(got['valid'].numpy(), valid)
    np.testing.assert_array_equal(got['labels'].numpy(),
                                  np.asarray(ref['labels']))
    np.testing.assert_allclose(got['dets'].numpy(), np.asarray(ref['dets']),
                               atol=1e-3)
    # every kept box is a proposal, clipped to its image
    for i in range(b):
        hw = img_shape[i]
        clipped = np.minimum(np.maximum(props[i], 0),
                             [hw[1], hw[0], hw[1], hw[0]])
        for box in got['dets'][i][got['valid'][i]][:, :4].numpy():
            assert np.isclose(clipped, box).all(-1).any()
