"""The one-stage core's parts against the JAX package, on seeded numpy
inputs: the point-distance coders, `atss_assign` (on a symmetric grid
whose centre distances tie at the k-th place), the quality, distribution
and GHM-C classification losses (values and gradients), RetinaNet's
`dense_focal_anchor_loss` in its focal and GHM forms (values and the
gradients of the head outputs), PAA's `gmm_split`, and the `DeformConv`
layer. Values within 1e-5 relative (1e-6 absolute), gradients within
1e-5 of their scale, assignments and masks exactly. PAA's padded
candidates: their order does not reach the loss."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .torch_port_utils import JAX_PKG, PORT_PKG


def _imp(name):
    return (importlib.import_module(f'{JAX_PKG}.{name}'),
            importlib.import_module(f'{PORT_PKG}.{name}'))


jcoders, tcoders = _imp('core.bbox.coders')
jatss, tatss = _imp('core.bbox.atss_assigner')
jgf, tgf = _imp('models.losses.gfocal_loss')
jfocal, tfocal = _imp('models.losses.focal_loss')
janchor, tanchor = _imp('models.dense_heads.anchor_head')
jpaa, tpaa = _imp('models.detectors.paa')
jplug, tplug = _imp('models.layers.plugins')
tconvert = importlib.import_module(f'{PORT_PKG}.utils.convert')


def _t(x, grad=False):
    t = torch.from_numpy(np.array(x))
    return t.requires_grad_() if grad else t


def _close(got, ref, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(
        got) else got), np.asarray(ref), rtol=rtol, atol=atol)


def _grad_close(got, ref, tol=1e-5):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-12)
    assert float(np.abs(got.numpy() - ref).max()) <= tol * scale


def _boxes(rs, shape, extent, lo, hi):
    xy = rs.uniform(0, extent - hi, shape + (2,))
    wh = rs.uniform(lo, hi, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_point_distance_coders_match():
    rs = np.random.RandomState(0)
    pts = rs.uniform(0, 200, (3, 50, 2)).astype(np.float32)
    dist = rs.uniform(0, 40, (3, 50, 4)).astype(np.float32)
    boxes = _boxes(rs, (3, 50), 200, 5, 60)
    shape = np.array([150, 180], np.float32)
    _close(tcoders.distance2bbox(_t(pts), _t(dist)),
           jcoders.distance2bbox(pts, dist))
    _close(tcoders.distance2bbox(_t(pts), _t(dist), _t(shape)),
           jcoders.distance2bbox(pts, dist, jnp.asarray(shape)))
    _close(tcoders.bbox2distance(_t(pts), _t(boxes)),
           jcoders.bbox2distance(pts, boxes))
    _close(tcoders.bbox2distance(_t(pts), _t(boxes), 16.0, 0.1),
           jcoders.bbox2distance(pts, boxes, 16.0, 0.1))


def _symmetric_grid(stride, h, w, scale=8):
    """One square anchor of `scale` x `stride` a location of an h x w map
    (centres at multiples of the stride, as the ATSS anchors)."""
    ys, xs = np.meshgrid(np.arange(h) * stride, np.arange(w) * stride,
                         indexing='ij')
    c = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)
    half = scale * stride / 2
    return np.concatenate([c - half, c + half], -1).astype(np.float32)


@pytest.mark.parametrize('topk', [9, 4])
def test_atss_assign_matches_with_distance_ties(topk):
    """Levels of strides 8, 16, 32 on a 128x192 canvas; gts centred on
    anchor centres or half-way between them, so centre distances tie at
    the k-th place (a level then admits more than k candidates), a gt at
    the grid's corner, one padded."""
    levels = [_symmetric_grid(s, 128 // s, 192 // s) for s in (8, 16, 32)]
    anchors = np.concatenate(levels)
    nla = tuple(len(a) for a in levels)
    gts = np.array([[[40, 40, 88, 88], [40, 44, 80, 84], [0, 0, 30, 30],
                     [96, 16, 176, 112], [0, 0, 0, 0]],
                    [[44, 28, 84, 68], [100, 60, 132, 100], [8, 8, 72, 40],
                     [60, 60, 62, 62], [0, 0, 0, 0]]], np.float32)
    valid = np.array([[1, 1, 1, 1, 0], [1, 1, 1, 1, 0]], bool)
    labels = np.array([[0, 1, 2, 3, 0], [3, 2, 1, 0, 0]], np.int32)
    # the distances tie at the k-th place for some gt and level
    ax = (anchors[:, 0] + anchors[:, 2]) / 2
    ay = (anchors[:, 1] + anchors[:, 3]) / 2
    d = np.sqrt((ax - 60) ** 2 + (ay - 64) ** 2)[:nla[0]]
    assert np.sum(d <= np.sort(d)[topk - 1]) > topk
    ref = jax.vmap(lambda g, v, l: jatss.atss_assign(
        jnp.asarray(anchors), nla, g, v, l, topk))(gts, valid, labels)
    got = tatss.atss_assign(_t(anchors), nla, _t(gts), _t(valid),
                            _t(labels), topk)
    for name in ('assigned_gt_inds', 'labels'):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    _close(got.max_overlaps, ref.max_overlaps)
    assert (got.assigned_gt_inds > 0).sum() >= 8


def _loss_and_grads(jfn, tfn, arrays, grad_args):
    """jfn / tfn over `arrays` (numpy), the scalar loss and the gradients
    of the arrays at `grad_args`."""
    ref, jg = jax.value_and_grad(
        lambda *a: jfn(*a), argnums=grad_args)(*map(jnp.asarray, arrays))
    ts = [_t(a, grad=i in grad_args) for i, a in enumerate(arrays)]
    got = tfn(*ts)
    tg = torch.autograd.grad(got, [ts[i] for i in grad_args])
    _close(got, ref)
    for g, r in zip(tg, jg):
        _grad_close(g, r)


def test_quality_focal_loss_and_gradients_match():
    rs = np.random.RandomState(1)
    logits = (rs.standard_normal((2, 300, 5)) * 3).astype(np.float32)
    labels = rs.randint(0, 6, (2, 300)).astype(np.int32)   # 5 = background
    quality = rs.uniform(0, 1, (2, 300)).astype(np.float32)
    weight = (rs.uniform(0, 1, (2, 300)) < 0.8).astype(np.float32)
    _loss_and_grads(
        lambda x, l, q, w: jgf.quality_focal_loss(x, l, q, w,
                                                  reduction='sum'),
        lambda x, l, q, w: tgf.quality_focal_loss(x, l.long(), q, w,
                                                  reduction='sum'),
        (logits, labels, quality, weight), (0, 2))
    q = tgf.QualityFocalLoss(loss_weight=0.5)
    _close(q(_t(logits), (_t(labels).long(), _t(quality))),
           0.5 * jgf.quality_focal_loss(logits, labels, quality))


def test_distribution_focal_loss_and_gradients_match():
    rs = np.random.RandomState(2)
    logits = (rs.standard_normal((400, 17)) * 2).astype(np.float32)
    target = rs.uniform(-1, 17.5, (400,)).astype(np.float32)
    target[:5] = [0.0, 16.0, 15.9999, 3.0, 7.5]
    weight = (rs.uniform(0, 1, (400,)) < 0.7).astype(np.float32)
    _loss_and_grads(
        lambda x, t, w: jgf.distribution_focal_loss(x, t, w, reduction='sum'),
        lambda x, t, w: tgf.distribution_focal_loss(x, t, w, reduction='sum'),
        (logits, target, weight), (0,))
    d = tgf.DistributionFocalLoss(loss_weight=0.25)
    _close(d(_t(logits), _t(target), _t(weight)),
           0.25 * jgf.distribution_focal_loss(logits, target, weight))


def test_ghm_classification_loss_and_gradients_match():
    """Per image, as the JAX function is vmapped in the anchor loss; the
    gradient norms of the terms fill every bin."""
    rs = np.random.RandomState(3)
    logits = (rs.standard_normal((2, 500, 3)) * 2.5).astype(np.float32)
    labels = rs.randint(0, 4, (2, 500)).astype(np.int32)
    valid = rs.uniform(0, 1, (2, 500)) < 0.9
    g = np.abs(1 / (1 + np.exp(-logits)) - np.eye(4)[labels][..., :3])
    assert len(np.unique(np.floor(g * 10))) == 10
    np.testing.assert_array_equal(tfocal.ghm_edges().numpy(),
                                  np.asarray(jnp.linspace(0, 1 + 1e-6, 11)))
    _loss_and_grads(
        lambda x, l, v: jnp.sum(jax.vmap(jfocal.ghm_classification_loss)(
            x, l, v)),
        lambda x, l, v: tfocal.ghm_classification_loss(x, l.long(), v).sum(),
        (logits, labels, valid), (0,))


def _retina_inputs(seed=4, b=2, h=128, w=192):
    rs = np.random.RandomState(seed)
    cfg = janchor.MultiAnchorConfig()
    sizes = [(-(-h // s), -(-w // s)) for s in cfg.strides]
    anchors = cfg.flat_anchors(sizes).astype(np.float32)
    n = len(anchors)
    return dict(cls=rs.standard_normal((b, n, 3)).astype(np.float32),
                reg=(rs.standard_normal((b, n, 4)) * 0.3).astype(np.float32),
                anchors=anchors,
                gt=_boxes(rs, (b, 5), 128, 12, 90),
                labels=rs.randint(0, 3, (b, 5)).astype(np.int32),
                valid=np.arange(5)[None] < np.array([[5], [2]]),
                img_shape=np.array([[h, w], [100, 150]], np.int32))


@pytest.mark.parametrize('loss_cls', ['focal', 'ghm'])
def test_dense_focal_anchor_loss_and_gradients_match(loss_cls):
    x = _retina_inputs()
    jcfg = janchor.DenseAnchorTrainConfig(loss_cls=loss_cls)
    tcfg = tanchor.DenseAnchorTrainConfig(loss_cls=loss_cls)

    def jfn(cls, reg):
        out = janchor.dense_focal_anchor_loss(
            cls, reg, jnp.asarray(x['anchors']), x['gt'], x['labels'],
            x['valid'], x['img_shape'], 3, jcfg)
        return out['loss_cls'] + 0.5 * out['loss_bbox'], out

    (ref, parts), jg = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x['cls']), jnp.asarray(x['reg']))
    cls, reg = _t(x['cls'], True), _t(x['reg'], True)
    out = tanchor.dense_focal_anchor_loss(
        cls, reg, _t(x['anchors']), _t(x['gt']), _t(x['labels']),
        _t(x['valid']), _t(x['img_shape']), 3, tcfg)
    for k in ('loss_cls', 'loss_bbox'):
        _close(out[k], parts[k])
    tg = torch.autograd.grad(out['loss_cls'] + 0.5 * out['loss_bbox'],
                             (cls, reg))
    for g, r in zip(tg, jg):
        _grad_close(g, r)


def _gmm_inputs(seed=6, g=12, k=45):
    rs = np.random.RandomState(seed)
    low = rs.normal(1.0, 0.3, (g, k))
    high = rs.normal(4.0, 0.8, (g, k))
    pick = rs.uniform(0, 1, (g, k)) < rs.uniform(0.1, 0.6, (g, 1))
    losses = np.where(pick, low, high).astype(np.float32)
    valid = rs.uniform(0, 1, (g, k)) < 0.85
    valid[-1] = False                     # a padded gt
    valid[-2, 1:] = False                 # one candidate
    return losses, valid


def test_gmm_split_matches():
    losses, valid = _gmm_inputs()
    ref = np.asarray(jpaa.gmm_split(jnp.asarray(losses), jnp.asarray(valid)))
    got = tpaa.gmm_split(_t(losses), _t(valid)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < valid.sum()
    assert not got[-1].any()


def test_paa_candidates_match_the_masked_top_k():
    """The level-sliced top-k equals the JAX package's masked top-k over
    every anchor, padded places included, on levels of 300, 40 and 6
    anchors (the last fewer than k) with equal losses inside and the
    outside-the-gt 1e8."""
    rs = np.random.RandomState(7)
    nla = (300, 40, 6)
    n = sum(nla)
    lvl = np.repeat(np.arange(3), nla)
    loss = np.round(rs.uniform(0, 5, (2, 4, n)), 1).astype(np.float32)
    loss[rs.uniform(0, 1, loss.shape) < 0.5] = 1e8
    idx, val, ok = tpaa.paa_candidates(_t(loss), nla, 9)
    for li in range(3):
        masked = np.where(lvl[None, None] == li, -loss, -1e9).astype(
            np.float32)
        v, ix = jax.lax.top_k(jnp.asarray(masked), 9)
        np.testing.assert_array_equal(idx[..., li * 9:(li + 1) * 9].numpy(),
                                      np.asarray(ix))
        np.testing.assert_array_equal(val[..., li * 9:(li + 1) * 9].numpy(),
                                      -np.asarray(v))
        np.testing.assert_array_equal(ok[..., li * 9:(li + 1) * 9].numpy(),
                                      np.asarray(v) > -1e8)


def test_paa_padded_candidates_do_not_reach_the_loss():
    """The padded candidates' (1e8 and 1e9 keys) indices reordered or
    pointed elsewhere leave `paa_loss` unchanged to the last bit."""
    rs = np.random.RandomState(8)
    x = _retina_inputs(seed=8)
    sizes = [(-(-128 // s), -(-192 // s)) for s in (8, 16, 32, 64, 128)]
    anchors, nla = tanchor.level_anchors((8, 16, 32, 64, 128), (1.0,), (8,),
                                         sizes, 'cpu')
    n = len(anchors)
    cls = _t(rs.standard_normal((2, n, 3)).astype(np.float32))
    reg = _t((rs.standard_normal((2, n, 4)) * 0.2).astype(np.float32))
    iou = _t(rs.standard_normal((2, n, 1)).astype(np.float32))
    batch = dict(gt_bboxes=_t(x['gt']), gt_labels=_t(x['labels']),
                 gt_valid=_t(x['valid']))
    ref = tpaa.paa_loss(cls, reg, iou, anchors, nla, batch, 3, 9)
    orig = tpaa.paa_candidates
    seen = []

    def shuffled(cand_loss, counts, k):
        idx, val, ok = orig(cand_loss, counts, k)
        other = torch.from_numpy(rs.randint(0, n, idx.shape))
        seen.append(int((~ok).sum()))
        return torch.where(ok, idx, other), val, ok

    tpaa.paa_candidates = shuffled
    try:
        got = tpaa.paa_loss(cls, reg, iou, anchors, nla, batch, 3, 9)
    finally:
        tpaa.paa_candidates = orig
    assert seen[0] > 0
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


def test_deform_conv_layer_matches():
    """The DCN layer with the JAX layer's kernel converted as the
    converter carries it: output and the gradients of input, offsets and
    kernel."""
    rs = np.random.RandomState(9)
    x = rs.standard_normal((2, 9, 11, 6)).astype(np.float32)
    off = (rs.standard_normal((2, 9, 11, 18)) * 1.5).astype(np.float32)
    layer = jplug.DeformConv(5)
    params = layer.init(jax.random.PRNGKey(0), jnp.asarray(x),
                        jnp.asarray(off))
    kernel = np.asarray(params['params']['kernel'])
    port = tplug.DeformConv(6, 5)
    state, unmapped = tconvert.from_jax_variables(
        {'params': {'kernel': kernel}}, port)
    assert unmapped == []
    port.load_state_dict(state)
    ref, jg = jax.value_and_grad(
        lambda p, a, o: jnp.sum(layer.apply(p, a, o) ** 2),
        argnums=(0, 1, 2))(params, jnp.asarray(x), jnp.asarray(off))
    tx, to = _t(x, True), _t(off, True)
    got = (port(tx, to) ** 2).sum()
    gx, go, gw = torch.autograd.grad(got, (tx, to, port.weight))
    _close(got, ref, rtol=1e-5)
    _grad_close(gx, jg[1])
    _grad_close(go, jg[2])
    _grad_close(gw, np.asarray(jg[0]['params']['kernel']).transpose(
        3, 2, 0, 1))
