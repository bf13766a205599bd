"""The RetinaNet-derived heads' parts against the JAX package, on seeded
numpy inputs and hand-made ties:

- the TBLR coders (both normalizations) and SABL's bucket coders, a gt
  edge on a bucket boundary (two buckets at the same distance) and tied
  bucket logits among the inputs;
- PISA's ISR-P and CARL weights, with tied rank keys;
- SABL's transposed conv alone (a non-symmetric kernel through the
  converter), then the whole `SABLBBoxHead`;
- the dense losses of FreeAnchor (bags over anchors tied at IoU 0), FSAF
  (a gt whose two levels tie exactly, and a gt with no point in its
  region), FoveaBox, SABL-RetinaNet and PISA-RetinaNet: values and the
  gradients of the head outputs, the JAX losses called on the same head
  outputs through a stand-in for their module;
- PISA's CARL weight is a constant of the step, as in the JAX package: no
  gradient of the box loss reaches the classifier (mmdet's `carl_loss`
  sends one);
- FreeAnchor's `bbox_thr + 1e-12` clip, which in float32 is the threshold
  itself.

Values within 1e-5 relative (1e-6 absolute), gradients within 1e-5 of
their scale, choices exactly."""

import importlib
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .torch_port_utils import JAX_PKG, PORT_PKG, fill_variables


def _imp(name):
    return (importlib.import_module(f'{JAX_PKG}.{name}'),
            importlib.import_module(f'{PORT_PKG}.{name}'))


jcoders, tcoders = _imp('core.bbox.coders')
jbucket, tbucket = _imp('core.bbox.extra_coders')
jextra, textra = _imp('models.losses.extra_losses')
janchor, tanchor = _imp('models.dense_heads.anchor_head')
jfree, tfree = _imp('models.detectors.free_anchor')
jfsaf, tfsaf = _imp('models.detectors.fsaf')
jfovea, tfovea = _imp('models.detectors.fovea')
jsabl, tsabl = _imp('models.detectors.sabl_retina')
jpisa, tpisa = _imp('models.detectors.pisa')
tconvert = importlib.import_module(f'{PORT_PKG}.utils.convert')
troi = importlib.import_module(f'{PORT_PKG}.models.roi_heads.'
                               'standard_roi_head')


def _t(x, grad=False):
    t = torch.from_numpy(np.array(x))
    return t.requires_grad_() if grad else t


def _close(got, ref, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(
        got) else got), np.asarray(ref), rtol=rtol, atol=atol)


def _grad_close(got, ref, tol=1e-5):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-12)
    err = float(np.abs(got.numpy() - ref).max())
    assert err <= tol * scale, (err, scale)


def _boxes(rs, shape, extent, lo, hi):
    xy = rs.uniform(0, extent - hi, shape + (2,))
    wh = rs.uniform(lo, hi, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


# ---- coders ---------------------------------------------------------------

@pytest.mark.parametrize('by_wh', [True, False])
def test_tblr_coders_match(by_wh):
    rs = np.random.RandomState(0)
    priors = _boxes(rs, (3, 20), 96, 4, 40)
    gts = _boxes(rs, (3, 20), 96, 4, 40)
    norm = 4.0 if by_wh else 1.0
    ref = jcoders.bbox2tblr(jnp.asarray(priors), jnp.asarray(gts), norm,
                            by_wh)
    got = tcoders.bbox2tblr(_t(priors), _t(gts), norm, by_wh)
    _close(got, ref)
    back = jcoders.tblr2bbox(jnp.asarray(priors), ref, norm, by_wh)
    _close(tcoders.tblr2bbox(_t(priors), got, norm, by_wh), back, atol=1e-4)
    shape = np.array([60, 70], np.float32)
    _close(tcoders.tblr2bbox(_t(priors), got, norm, by_wh, _t(shape)),
           jcoders.tblr2bbox(jnp.asarray(priors), ref, norm, by_wh,
                             jnp.asarray(shape)), atol=1e-4)


def _bucket_inputs():
    """Proposals, gts and bucket predictions: random rows, then a proposal
    of 140 px at scale 1 (buckets 10 px wide) whose gt's left and top
    edges lie on a bucket boundary (two buckets at 0.5 each), with its
    logits tied between neighbouring and far buckets."""
    rs = np.random.RandomState(1)
    props = _boxes(rs, (12,), 200, 20, 120)
    gts = props + rs.uniform(-15, 15, props.shape).astype(np.float32)
    props = np.concatenate([props, [[0, 0, 140, 140]]]).astype(np.float32)
    gts = np.concatenate([gts, [[10, 20, 133, 127]]]).astype(np.float32)
    cls = rs.standard_normal((13, 28)).astype(np.float32)
    cls[-1, :7] = [3, 3, 0, 0, 0, 0, 0]             # neighbours tie
    cls[-1, 7:14] = [2, 0, 0, 0, 2, 0, 0]           # far buckets tie
    cls[-1, 14:21] = 1.0                            # all seven tie
    off = rs.standard_normal((13, 28)).astype(np.float32) * 0.3
    return props, gts, cls, off


@pytest.mark.parametrize('scale_factor', [1.0, 1.7])
def test_bucket_coders_match_with_ties(scale_factor):
    props, gts, cls, off = _bucket_inputs()
    ref = jbucket.bbox2bucket(jnp.asarray(props), jnp.asarray(gts), 14,
                              scale_factor)
    got = tbucket.bbox2bucket(_t(props), _t(gts), 14, scale_factor)
    for g, r in zip(got, ref):
        _close(g, r)
    if scale_factor == 1.0:       # the boundary row: buckets 0 and 1 tie
        assert float(got[0][-1, 0].abs()) == float(got[0][-1, 1].abs()) \
            == 0.5
        assert got[2][-1, :7].tolist() == [1, 0, 0, 0, 0, 0, 0]
    boxes, conf = tbucket.bucket2bbox(_t(props), _t(cls), _t(off), 14,
                                      scale_factor)
    rb, rc = jbucket.bucket2bbox(jnp.asarray(props), jnp.asarray(cls),
                                 jnp.asarray(off), 14, scale_factor)
    _close(boxes, rb, atol=1e-4)
    _close(conf, rc)
    # batched leading dims give the rows' values
    b2, c2 = tbucket.bucket2bbox(_t(props).reshape(1, 13, 4),
                                 _t(cls)[None], _t(off)[None], 14,
                                 scale_factor)
    assert torch.equal(b2[0], boxes) and torch.equal(c2[0], conf)


# ---- ISR-P and CARL -------------------------------------------------------

def _pisa_weight_inputs():
    """Two images of 40 rows: labels among 3 classes, IoUs with repeats
    (tied rank keys within a class), about half positive."""
    rs = np.random.RandomState(2)
    labels = rs.randint(0, 3, (2, 40)).astype(np.int32)
    ious = rs.choice(np.float32([0.5, 0.625, 0.75, 0.8125]), (2, 40))
    valid = rs.uniform(0, 1, (2, 40)) < 0.55
    scores = rs.uniform(0, 1, (2, 40)).astype(np.float32)
    return labels, ious.astype(np.float32), valid, scores


@pytest.mark.parametrize('k,bias', [(2.0, 0.0), (1.0, 0.2)])
def test_isr_p_weights_match_with_tied_keys(k, bias):
    labels, ious, valid, _ = _pisa_weight_inputs()
    key = labels * 2.0 + ious
    assert any(len(set(key[i][valid[i]])) < valid[i].sum() for i in range(2))
    ref = jax.vmap(lambda s, i, l, v: jextra.isr_p_weights(
        s, i, l, v, 3, k=k, bias=bias))(jnp.zeros_like(ious), ious, labels,
                                        valid)
    got = textra.isr_p_weights(torch.zeros(2, 40), _t(ious), _t(labels),
                               _t(valid), 3, k=k, bias=bias)
    _close(got, ref)
    one = textra.isr_p_weights(torch.zeros(40), _t(ious[0]), _t(labels[0]),
                               _t(valid[0]), 3, k=k, bias=bias)
    _close(one, ref[0])


def test_carl_weights_match():
    _, _, valid, scores = _pisa_weight_inputs()
    ref = jax.vmap(jextra.carl_weights)(jnp.asarray(scores),
                                        jnp.asarray(valid))
    _close(textra.carl_weights(_t(scores), _t(valid)), ref)
    none = np.zeros_like(valid)
    _close(textra.carl_weights(_t(scores), _t(none)),
           jax.vmap(jextra.carl_weights)(jnp.asarray(scores),
                                         jnp.asarray(none)))


# ---- SABL's box head ------------------------------------------------------

def test_transposed_conv_takes_the_flipped_flax_kernel():
    """flax `ConvTranspose((2,), strides=(2,))` puts x[i] · k[1 - j] at
    2i + j; the converter flips the kernel for torch's x[i] · w[j]."""
    flax_conv = fnn.ConvTranspose(1, (2,), strides=(2,), use_bias=False)
    k = np.array([1.0, 2.0], np.float32).reshape(2, 1, 1)
    y = flax_conv.apply({'params': {'kernel': k}},
                        jnp.asarray([[[1.0], [10.0], [100.0]]]))
    np.testing.assert_array_equal(np.asarray(y)[0, :, 0],
                                  [2, 1, 20, 10, 200, 100])

    rs = np.random.RandomState(3)
    x = rs.standard_normal((5, 7, 6)).astype(np.float32)       # (B, L, C)
    variables = {'params': {
        'kernel': rs.standard_normal((2, 6, 4)).astype(np.float32),
        'bias': rs.standard_normal((4,)).astype(np.float32)}}
    ref = fnn.ConvTranspose(4, (2,), strides=(2,)).apply(variables,
                                                         jnp.asarray(x))
    conv = torch.nn.ConvTranspose1d(6, 4, 2, stride=2)
    key, w = tconvert._convert_leaf('params', ('up_x', 'kernel'),
                                    variables['params']['kernel'])
    assert key == 'up_x.weight' and w.shape == (6, 4, 2)
    with torch.no_grad():
        conv.weight.copy_(_t(w))
        conv.bias.copy_(_t(variables['params']['bias']))
    got = conv(_t(x).transpose(1, 2)).transpose(1, 2)
    assert got.shape == (5, 14, 4)
    _close(got, ref)


def test_sabl_bbox_head_matches():
    rs = np.random.RandomState(4)
    feats = rs.standard_normal((2, 5, 7, 7, 16)).astype(np.float32)
    jhead = jsabl.SABLBBoxHead(num_classes=3, feat_channels=16,
                               fc_channels=32)
    shapes = jax.eval_shape(lambda: jhead.init(jax.random.PRNGKey(0),
                                               jnp.asarray(feats)))
    variables = fill_variables(shapes, rs)
    ref = jhead.apply(variables, jnp.asarray(feats))
    head = tsabl.SABLBBoxHead(num_classes=3, in_channels=16,
                              feat_channels=16, fc_channels=32)
    state, unmapped = tconvert.from_jax_variables(variables, head)
    assert unmapped == [] and set(state) == set(head.state_dict())
    head.load_state_dict(state)
    got = head(_t(feats))
    assert [tuple(g.shape) for g in got] == [(2, 5, 4), (2, 5, 28),
                                             (2, 5, 28)]
    for g, r in zip(got, ref):
        _close(g, r, rtol=1e-4, atol=1e-5)


# ---- the dense losses -----------------------------------------------------

SIZES = ((8, 12), (4, 6), (2, 3), (1, 2), (1, 1))     # a 64x96 canvas
STRIDES = (8, 16, 32, 64, 128)


def _gts():
    """Two images: 3 and 2 valid gts of 8–40 px, one of 1 px (its IoU
    with every anchor at most tiny, its FSAF region empty)."""
    rs = np.random.RandomState(5)
    gt = _boxes(rs, (2, 4), 64, 8, 40)
    gt[1, 1] = [70, 50, 71, 51]
    return dict(gt_bboxes=gt, gt_labels=rs.randint(0, 3, (2, 4)).astype(
        np.int32), gt_valid=np.arange(4)[None] < np.array([[3], [2]]),
        img_shape=np.array([[64, 96], [56, 90]], np.int32))


def _fake(**attrs):
    """A stand-in for a JAX detector module: its loss methods read only
    these attributes."""
    return types.SimpleNamespace(**attrs)


def _both(jloss, tloss, inputs):
    """The JAX and port losses on the same head outputs `inputs` (the
    float ones differentiated): values, and gradients of their sum."""
    names = list(inputs)

    def jf(*xs):
        out = jloss(*xs)
        return sum(out.values()), out
    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jf, argnums=tuple(range(len(names))), has_aux=True))(
            *[jnp.asarray(inputs[n]) for n in names])
    ts = [_t(inputs[n], grad=True) for n in names]
    tout = tloss(*ts)
    sum(tout.values()).backward()
    assert set(tout) == set(jout)
    for k in jout:
        assert float(jout[k]) > 0, k
        _close(tout[k], jout[k])
    for n, t, g in zip(names, ts, jgrads):
        _grad_close(t.grad, g)
    return tout


def _batch(j, g):
    return {k: (jnp.asarray(v) if j else _t(v)) for k, v in g.items()}


def test_free_anchor_loss_matches_with_bags_tied_at_zero_iou():
    g = _gts()
    anchors = tanchor.MultiAnchorConfig().flat_anchors(SIZES).astype(
        np.float32)
    n = len(anchors)
    rs = np.random.RandomState(6)
    inputs = dict(cls=rs.standard_normal((2, n, 3)).astype(np.float32) - 2,
                  reg=(rs.standard_normal((2, n, 4)) * 0.2).astype(
                      np.float32))
    ious = np.asarray(jfree.bbox_overlaps(jnp.asarray(g['gt_bboxes'][1, 1:2]),
                                          jnp.asarray(anchors)))
    assert (ious == 0).sum() > 50           # the tiny gt's bag is all ties

    def jloss(cls, reg):
        fake = _fake(pre_anchor_topk=50, num_classes=3, smooth_l1_beta=0.11,
                     gamma=2.0, alpha=0.5, bbox_thr=0.6,
                     _forward_flat=lambda image: (cls, reg,
                                                  jnp.asarray(anchors)))
        return jfree.FreeAnchor.loss(fake, dict(_batch(True, g), image=None))

    def tloss(cls, reg):
        return tfree.free_anchor_loss(cls, reg, _t(anchors),
                                      _t(g['gt_bboxes']), _t(g['gt_labels']),
                                      _t(g['gt_valid']), 3)
    _both(jloss, tloss, inputs)


def test_free_anchor_upper_threshold_is_the_threshold_in_f32():
    """`bbox_thr + 1e-12` rounds to `bbox_thr` in float32: where no
    prediction passes the threshold the quotient's denominator is 0, and
    its clip gives 0 (no epsilon), as in the JAX package."""
    t1 = 0.6
    top = torch.tensor([0.3, 0.6, 0.7])
    t2 = torch.maximum(top, top.new_tensor(t1 + 1e-12))
    assert t2.tolist()[:2] == [np.float32(0.6)] * 2
    assert float(t2[0] - t1) == 0.0
    pred = torch.tensor([0.1, 0.3])
    assert ((pred - t1) / (t2[0] - t1)).clamp(0, 1).tolist() == [0.0, 0.0]
    ref = jnp.clip(jnp.asarray([0.3]), t1 + 1e-12, None)
    assert float(ref[0] - t1) == 0.0


def _fsaf_inputs():
    """FSAF's head outputs on SIZES and gts where the first image's last
    gt [2, 2, 42, 42] has one effective point on level 0 (20, 20) and one
    on level 1 (24, 24), each predicting the gt exactly with equal logits:
    its two levels' mean losses tie and the lower level is chosen."""
    g = _gts()
    g['gt_bboxes'][0, 2] = [2, 2, 42, 42]
    g['gt_labels'][0, 2] = 1
    pts, strs, lvl = (t.numpy() for t in tfsaf.fsaf_points(SIZES, STRIDES))
    n = len(pts)
    rs = np.random.RandomState(7)
    cls = rs.standard_normal((2, n, 3)).astype(np.float32) - 1
    reg = rs.uniform(0.1, 1.0, (2, n, 4)).astype(np.float32)
    for x, y, s in ((20, 20, 8), (24, 24, 16)):
        i = int(np.flatnonzero((pts[:, 0] == x) & (pts[:, 1] == y)
                               & (strs == s))[0])
        norm = s * 4.0
        reg[0, i] = [(y - 2) / norm, (42 - y) / norm, (x - 2) / norm,
                     (42 - x) / norm]
        cls[0, i] = 0.5
    return g, pts, strs, lvl, dict(cls=cls, reg=reg)


def test_fsaf_chooses_the_first_of_tied_levels():
    mean = torch.tensor([[0.7, 0.7, 0.9], [float('inf')] * 3,
                         [1.0, 0.2, 0.2]])
    ref = jnp.argmin(jnp.asarray(mean.numpy()), axis=1)
    assert tfsaf.select_levels(mean).tolist() == np.asarray(ref).tolist() \
        == [0, 0, 1]
    g, pts, strs, lvl, inputs = _fsaf_inputs()
    captured = []
    orig = tfsaf.select_levels
    tfsaf.select_levels = lambda m: captured.append(m) or orig(m)
    try:
        tfsaf.fsaf_loss(_t(inputs['cls']), _t(inputs['reg']), _t(pts),
                        _t(strs), _t(lvl), 5, _t(g['gt_bboxes']),
                        _t(g['gt_labels']), _t(g['gt_valid']), 3)
    finally:
        tfsaf.select_levels = orig
    row = captured[0][0, 2]
    assert float(row[0]) == float(row[1]) and orig(row).item() == 0
    assert torch.isinf(captured[0][1, 1]).all()     # the 1-px gt


def test_fsaf_loss_matches_with_a_tied_level():
    g, pts, strs, lvl, inputs = _fsaf_inputs()

    def jloss(cls, reg):
        fake = _fake(strides=STRIDES, num_classes=3, pos_scale=0.2,
                     ignore_scale=0.5, normalize_factor=4.0)
        fake._regions = lambda gt, p: jfsaf.FSAF._regions(fake, gt, p)
        fake._forward_flat = lambda image: (cls, reg, jnp.asarray(pts),
                                            jnp.asarray(strs),
                                            jnp.asarray(lvl))
        return jfsaf.FSAF.loss(fake, dict(_batch(True, g), image=None))

    def tloss(cls, reg):
        return tfsaf.fsaf_loss(cls, reg, _t(pts), _t(strs), _t(lvl), 5,
                               _t(g['gt_bboxes']), _t(g['gt_labels']),
                               _t(g['gt_valid']), 3)
    _both(jloss, tloss, inputs)


def test_fovea_loss_matches():
    g = _gts()
    grid = [t.numpy() for t in tfovea.fovea_grid(SIZES, STRIDES)]
    n = len(grid[0])
    rs = np.random.RandomState(8)
    inputs = dict(cls=rs.standard_normal((2, n, 3)).astype(np.float32),
                  reg=rs.standard_normal((2, n, 4)).astype(np.float32))
    strs = np.repeat(np.float32(STRIDES), [h * w for h, w in SIZES])

    def jloss(cls, reg):
        fake = _fake(num_classes=3, sigma=0.4, _forward_flat=lambda image: (
            cls, reg, jnp.asarray(grid[0]), jnp.asarray(strs),
            *map(jnp.asarray, grid[1:])))
        return jfovea.FoveaBox.loss(fake, dict(_batch(True, g), image=None))

    def tloss(cls, reg):
        return tfovea.fovea_loss(cls, reg, *map(_t, grid),
                                 _t(g['gt_bboxes']), _t(g['gt_labels']),
                                 _t(g['gt_valid']), 3)
    _both(jloss, tloss, inputs)


def test_sabl_retina_loss_matches():
    g = _gts()
    anchors, _ = tanchor.level_anchors(STRIDES, (1.0,), (4,), SIZES, 'cpu')
    anchors = anchors.numpy()
    n = len(anchors)
    rs = np.random.RandomState(9)
    inputs = dict(cls=rs.standard_normal((2, n, 3)).astype(np.float32),
                  bc=rs.standard_normal((2, n, 28)).astype(np.float32),
                  bo=(rs.standard_normal((2, n, 28)) * 0.5).astype(
                      np.float32))

    def jloss(cls, bc, bo):
        fake = _fake(num_classes=3, scale_factor=1.7,
                     _forward_flat=lambda image: (cls, bc, bo,
                                                  jnp.asarray(anchors)))
        return jsabl.SABLRetinaNet.loss(fake, dict(_batch(True, g),
                                                   image=None))

    def tloss(cls, bc, bo):
        return tsabl.sabl_retina_loss(cls, bc, bo, _t(anchors),
                                      _t(g['gt_bboxes']), _t(g['gt_labels']),
                                      _t(g['gt_valid']), 3)
    _both(jloss, tloss, inputs)


def _pisa_anchor_inputs():
    g = _gts()
    anchors = tanchor.MultiAnchorConfig().flat_anchors(SIZES).astype(
        np.float32)
    n = len(anchors)
    rs = np.random.RandomState(10)
    return g, anchors, dict(
        cls=rs.standard_normal((2, n, 3)).astype(np.float32) - 1,
        reg=(rs.standard_normal((2, n, 4)) * 0.2).astype(np.float32))


def test_pisa_anchor_loss_matches():
    g, anchors, inputs = _pisa_anchor_inputs()

    def jloss(cls, reg):
        return jpisa.pisa_anchor_loss(
            cls, reg, jnp.asarray(anchors), *[jnp.asarray(g[k]) for k in (
                'gt_bboxes', 'gt_labels', 'gt_valid', 'img_shape')], 3,
            janchor.DenseAnchorTrainConfig())

    def tloss(cls, reg):
        return tpisa.pisa_anchor_loss(
            cls, reg, _t(anchors), *[_t(g[k]) for k in (
                'gt_bboxes', 'gt_labels', 'gt_valid', 'img_shape')], 3)
    _both(jloss, tloss, inputs)


def test_pisa_carl_weight_sends_no_gradient_to_the_classifier():
    """The box loss's gradient of the class logits is zero on both sides
    (anchor PISA), and on the port's RoI form: CARL's score is detached,
    as the JAX package detaches it."""
    g, anchors, inputs = _pisa_anchor_inputs()
    jgrad = jax.jit(jax.grad(lambda cls: jpisa.pisa_anchor_loss(
        cls, jnp.asarray(inputs['reg']), jnp.asarray(anchors),
        *[jnp.asarray(g[k]) for k in ('gt_bboxes', 'gt_labels', 'gt_valid',
                                      'img_shape')], 3,
        janchor.DenseAnchorTrainConfig())['loss_bbox']))(
            jnp.asarray(inputs['cls']))
    assert not np.asarray(jgrad).any()
    cls, reg = _t(inputs['cls'], grad=True), _t(inputs['reg'], grad=True)
    out = tpisa.pisa_anchor_loss(cls, reg, _t(anchors), *[_t(g[k]) for k in (
        'gt_bboxes', 'gt_labels', 'gt_valid', 'img_shape')], 3)
    gc, gr = torch.autograd.grad(out['loss_bbox'], (cls, reg),
                                 allow_unused=True)
    assert (gc is None or not gc.any()) and gr.abs().sum() > 0

    rs = np.random.RandomState(11)
    b, s, c = 2, 24, 3
    rois = torch.from_numpy(_boxes(rs, (b, s), 64, 8, 40))
    is_pos = torch.from_numpy(rs.uniform(0, 1, (b, s)) < 0.4)
    sampled = troi.SampledRoIs(
        rois, torch.where(is_pos, torch.from_numpy(rs.randint(0, c, (b, s))),
                          torch.tensor(c)),
        torch.ones(b, s, dtype=torch.bool), is_pos,
        torch.from_numpy(rs.standard_normal((b, s, 4)).astype(np.float32)),
        torch.from_numpy(rs.randint(0, 3, (b, s))))
    scores = torch.randn(b, s, c + 1, requires_grad=True)
    deltas = torch.randn(b, s, 4 * c, requires_grad=True)
    out = tpisa.pisa_roi_losses(scores, deltas, sampled,
                                _t(_gts()['gt_bboxes'][:, :3]), c)
    gc, gr = torch.autograd.grad(out['loss_bbox'], (scores, deltas),
                                 allow_unused=True)
    assert (gc is None or not gc.any()) and gr.abs().sum() > 0
