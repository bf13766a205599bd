"""The parts the proposal-network family is built of, against the JAX
package on the same seeded inputs: the IoU-family losses (values and
gradients), `center_region_assign`, the sigmoid focal loss,
`dense_anchor_predict` and `LoadProposals`.

Tolerances: losses and gradients within 1e-5 of their scale (1e-6
absolute for the focal loss's values); assignments, labels and validity
identical; detections within 1e-4."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .torch_port_utils import JAX_PKG, PORT_PKG

jiou = importlib.import_module(f'{JAX_PKG}.models.losses.iou_loss')
tiou = importlib.import_module(f'{PORT_PKG}.models.losses.iou_loss')
jfocal = importlib.import_module(f'{JAX_PKG}.models.losses.focal_loss')
tfocal = importlib.import_module(f'{PORT_PKG}.models.losses.focal_loss')
jassign = importlib.import_module(f'{JAX_PKG}.core.bbox.extra_assigners')
tassign = importlib.import_module(f'{PORT_PKG}.core.bbox.extra_assigners')
janchor = importlib.import_module(f'{JAX_PKG}.models.dense_heads.anchor_head')
tanchor = importlib.import_module(f'{PORT_PKG}.models.dense_heads.anchor_head')
jtf = importlib.import_module(f'{JAX_PKG}.data.pipelines.transforms')
ttf = importlib.import_module(f'{PORT_PKG}.data.pipelines.transforms')
tregistry = importlib.import_module(f'{PORT_PKG}.utils.registry')


def _boxes(rs, n, extent=100.0, lo=2.0, hi=40.0):
    xy = rs.uniform(0, extent, (n, 2))
    wh = rs.uniform(lo, hi, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _close(got, ref, tol, name=''):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, name
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f'{name}: {err:.3e} > {tol} x {scale:.3e}'


# ---- IoU-family losses ------------------------------------------------

def _pairs(seed, n=40):
    """Predicted and target boxes: overlapping, disjoint, nested, equal,
    one degenerate, one on the other's edge."""
    rs = np.random.RandomState(seed)
    target = _boxes(rs, n)
    pred = target + rs.normal(0, 8.0, target.shape).astype(np.float32)
    pred[:4] = _boxes(rs, 4, 300.0) + 400.0          # disjoint
    pred[4] = target[4] + [2, 2, -2, -2]                 # nested
    pred[5] = target[5]                                  # equal
    pred[6] = [10, 10, 10, 30]                           # zero width
    return pred.astype(np.float32), target, \
        rs.uniform(0, 1, n).astype(np.float32)


LOSSES = {'iou': dict(), 'iou_linear': dict(linear=True), 'giou': dict(),
          'diou': dict(), 'ciou': dict(), 'bounded_iou': dict(),
          'bounded_iou_beta': dict(beta=0.1, eps=1e-2)}


@pytest.mark.parametrize('reduction', ['none', 'sum', 'mean'])
@pytest.mark.parametrize('loss', sorted(LOSSES))
def test_iou_losses_and_their_gradients_match_jax(loss, reduction):
    pred, target, weight = _pairs(1)
    fn = loss.split('_linear')[0].replace('_beta', '') + '_loss'
    kw = dict(LOSSES[loss], weight=weight, reduction=reduction)

    def jf(p, t):
        out = getattr(jiou, fn)(p, t, **{**kw, 'weight': jnp.asarray(weight)})
        return jnp.sum(out * (1.0 + jnp.arange(out.size).reshape(out.shape)
                              % 3)), out
    (_, jout), (jgp, jgt) = jax.value_and_grad(jf, argnums=(0, 1),
                                               has_aux=True)(
        jnp.asarray(pred), jnp.asarray(target))
    p = torch.tensor(pred, requires_grad=True)
    t = torch.tensor(target, requires_grad=True)
    out = getattr(tiou, fn)(p, t, **{**kw, 'weight': torch.tensor(weight)})
    (out * (1.0 + torch.arange(out.numel()).reshape(out.shape) % 3)).sum(
        ).backward()
    _close(out.detach(), jout, 1e-5, 'loss')
    _close(p.grad, jgp, 1e-5, 'd_pred')
    _close(t.grad, jgt, 1e-5, 'd_target')


@pytest.mark.parametrize('name,kw', [('IoULoss', dict(linear=True)),
                                     ('IoULoss', dict(eps=1e-3)),
                                     ('GIoULoss', dict(loss_weight=2.0)),
                                     ('BoundedIoULoss', dict(beta=0.3))])
def test_iou_loss_classes_match_jax(name, kw):
    pred, target, weight = _pairs(2)
    jl = getattr(jiou, name)(**kw)
    tl = tregistry.LOSSES.build(dict(type=name, **kw))
    for extra in (dict(), dict(avg_factor=7.0),
                  dict(reduction_override='sum')):
        ref = jl(jnp.asarray(pred), jnp.asarray(target),
                 weight=jnp.asarray(weight), **extra)
        got = tl(torch.tensor(pred), torch.tensor(target),
                 weight=torch.tensor(weight), **extra)
        _close(got, ref, 1e-6, f'{name} {extra}')


# ---- center-region assignment ------------------------------------------

def _priors(rs, n=300, extent=120.0):
    c = rs.uniform(0, extent, (n, 2))
    half = rs.uniform(2, 20, (n, 1))
    return np.concatenate([c - half, c + half], -1).astype(np.float32)


@pytest.mark.parametrize('valid', ['some', 'none', 'all'])
@pytest.mark.parametrize('with_labels', [False, True])
@pytest.mark.parametrize('scales', [(0.2, 0.2), (0.2, 0.5), (0.5, 1.0)])
def test_center_region_assign_matches_jax(valid, with_labels, scales):
    rs = np.random.RandomState(3)
    priors = _priors(rs)
    gts = _boxes(rs, 7, 100.0, 10.0, 60.0)
    gts[2] = gts[1]                   # two equal gts: the first one wins
    gts[3, 2:] = gts[3, :2] + 30.0    # nested, smaller
    gts[4] = gts[3] - [5, 5, -5, -5]  # and larger
    gv = {'some': np.array([1, 1, 1, 1, 1, 0, 1], bool),
          'none': np.zeros(7, bool), 'all': np.ones(7, bool)}[valid]
    labels = rs.randint(0, 5, 7).astype(np.int32)
    pos, neg = scales
    ref = jassign.center_region_assign(
        jnp.asarray(priors), jnp.asarray(gts), jnp.asarray(gv),
        jnp.asarray(labels) if with_labels else None, pos, neg)
    got = tassign.center_region_assign(
        torch.tensor(priors), torch.tensor(gts), torch.tensor(gv),
        torch.tensor(labels) if with_labels else None, pos, neg)
    np.testing.assert_array_equal(got.assigned_gt_inds.numpy(),
                                  np.asarray(ref.assigned_gt_inds))
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(ref.labels))
    np.testing.assert_allclose(got.max_overlaps.numpy(),
                               np.asarray(ref.max_overlaps), atol=1e-6)
    assert (got.assigned_gt_inds > 0).any() == (valid != 'none')


def test_center_region_assign_takes_a_batch_as_jax_vmaps_it():
    rs = np.random.RandomState(4)
    priors = _priors(rs)
    gts = np.stack([_boxes(rs, 5, 100.0, 10.0, 60.0) for _ in range(3)])
    gv = rs.uniform(size=(3, 5)) < 0.7
    gv[2] = False
    ref = jax.vmap(lambda g, v: jassign.center_region_assign(
        jnp.asarray(priors), g, v))(jnp.asarray(gts), jnp.asarray(gv))
    got = tassign.center_region_assign(torch.tensor(priors),
                                       torch.tensor(gts), torch.tensor(gv))
    np.testing.assert_array_equal(got.assigned_gt_inds.numpy(),
                                  np.asarray(ref.assigned_gt_inds))
    np.testing.assert_allclose(got.max_overlaps.numpy(),
                               np.asarray(ref.max_overlaps), atol=1e-6)


# ---- focal loss --------------------------------------------------------

@pytest.mark.parametrize('reduction,avg', [('none', None), ('sum', None),
                                           ('mean', None), ('mean', 11.0)])
@pytest.mark.parametrize('weighted', [False, 'anchor', 'class'])
@pytest.mark.parametrize('gamma,alpha', [(2.0, 0.25), (1.5, 0.5)])
def test_sigmoid_focal_loss_and_its_gradient_match_jax(reduction, avg,
                                                       weighted, gamma,
                                                       alpha):
    rs = np.random.RandomState(6)
    logits = (rs.standard_normal((2, 30, 4)) * 4).astype(np.float32)
    logits[0, 0] = (40.0, -40.0, 0.0, 1e-3)       # saturated and at zero
    labels = rs.randint(-1, 5, (2, 30)).astype(np.int32)  # 4: background
    weight = {False: None,
              'anchor': rs.uniform(0, 1, (2, 30)).astype(np.float32),
              'class': rs.uniform(0, 1, (2, 30, 4)).astype(np.float32)
              }[weighted]
    kw = dict(gamma=gamma, alpha=alpha, reduction=reduction, avg_factor=avg)

    def jf(x):
        out = jfocal.sigmoid_focal_loss(
            x, jnp.asarray(labels),
            None if weight is None else jnp.asarray(weight), **kw)
        return jnp.sum(out), out
    (_, ref), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    got = tfocal.sigmoid_focal_loss(
        x, torch.tensor(labels).long(),
        None if weight is None else torch.tensor(weight), **kw)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)
    _close(x.grad, jg, 1e-5, 'd_logits')


# ---- the single-stage test path ----------------------------------------

@pytest.mark.parametrize('per_image', [False, True])
@pytest.mark.parametrize('cfg', [dict(), dict(nms_pre=60, max_per_img=25),
                                 dict(score_thr=0.3, nms_iou_threshold=0.3,
                                      target_stds=(0.07, 0.07, 0.14, 0.14))])
def test_dense_anchor_predict_matches_jax(per_image, cfg):
    """Top-k over anchor x class (the NEG_INF ties under `score_thr` to the
    lower index), decode, clip, class-aware NMS: the same detections, and
    zero past the valid rows."""
    rs = np.random.RandomState(8)
    b, n, c = 2, 150, 3
    anchors = _boxes(rs, n, 140.0, 8.0, 50.0)
    if per_image:
        anchors = np.stack([anchors, _boxes(rs, n, 140.0, 8.0, 50.0)])
    cls = (rs.standard_normal((b, n, c)) * 2 - 4).astype(np.float32)
    cls[1, :40] = -30.0                    # far under any threshold
    reg = (rs.standard_normal((b, n, 4)) * 0.3).astype(np.float32)
    shape = np.array([[150, 160], [120, 90]], np.int32)
    jcfg = janchor.DensePredictConfig(**cfg)
    tcfg = tanchor.DensePredictConfig(**cfg)
    if per_image:
        ref = jax.vmap(lambda cl, r, a, s: jax.tree_util.tree_map(
            lambda x: x[0], janchor.dense_anchor_predict(
                cl[None], r[None], a, s[None], c, jcfg)))(
            jnp.asarray(cls), jnp.asarray(reg), jnp.asarray(anchors),
            jnp.asarray(shape))
    else:
        ref = janchor.dense_anchor_predict(
            jnp.asarray(cls), jnp.asarray(reg), jnp.asarray(anchors),
            jnp.asarray(shape), c, jcfg)
    got = tanchor.dense_anchor_predict(
        torch.tensor(cls), torch.tensor(reg), torch.tensor(anchors),
        torch.tensor(shape), c, tcfg)
    valid = np.asarray(ref['valid'])
    # at the higher threshold, padded rows past the detections
    assert valid.any() and not (valid.all() and 'score_thr' in cfg)
    np.testing.assert_array_equal(got['valid'].numpy(), valid)
    np.testing.assert_array_equal(got['labels'].numpy(),
                                  np.asarray(ref['labels']))
    np.testing.assert_allclose(got['dets'].numpy(), np.asarray(ref['dets']),
                               atol=1e-4)


# ---- LoadProposals -----------------------------------------------------

@pytest.mark.parametrize('n,cols,num_max', [(0, 4, 5), (3, 4, 5), (9, 5, 5),
                                            (5, 5, 5), (None, 4, 7)])
def test_load_proposals_matches_jax(n, cols, num_max):
    rs = np.random.RandomState(n or 0)
    results = {} if n is None else dict(
        proposals=rs.uniform(0, 50, (n, cols)).astype(np.float64))
    ref = jtf.LoadProposals(num_max)(dict(results))
    got = ttf.LoadProposals(num_max)(dict(results))
    for k in ('proposals', 'proposals_valid'):
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape
        np.testing.assert_array_equal(got[k], ref[k])
    assert got['proposals_valid'].sum() == min(n or 0, num_max)
