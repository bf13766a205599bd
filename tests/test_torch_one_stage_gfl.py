"""GFL against the JAX package: the whole detector
(`test_torch_one_stage.one_stage_case`, whose tolerances these are; the
R50 config with an R18 trunk and 4 classes), and its loss's gradient with
respect to the head's outputs, which flows through the undetached IoU
quality (the QFL target, the GIoU weight and the normalizer Σ quality)
as in the JAX package: the JAX side is `gfl.py`'s loss written over the
JAX package's own parts."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .test_torch_cascade import _t, check_losses, check_update
from .test_torch_one_stage import one_stage_case, train_batch
from .test_torch_rpn_detectors import check_predict
from .torch_port_utils import JAX_PKG, PORT_PKG

KEYS = {'loss_cls', 'loss_bbox', 'loss_dfl'}
CONFIG = 'configs/gfl/gfl_r50_fpn_1x.py'

jgfl = importlib.import_module(f'{JAX_PKG}.models.detectors.gfl')
jatss = importlib.import_module(f'{JAX_PKG}.core.bbox.atss_assigner')
jcoders = importlib.import_module(f'{JAX_PKG}.core.bbox.coders')
jiou = importlib.import_module(f'{JAX_PKG}.core.bbox.iou')
jlosses = importlib.import_module(f'{JAX_PKG}.models.losses')
jgfocal = importlib.import_module(f'{JAX_PKG}.models.losses.gfocal_loss')
tgfl = importlib.import_module(f'{PORT_PKG}.models.detectors.gfl')
tanchor = importlib.import_module(f'{PORT_PKG}.models.dense_heads.anchor_head')


@pytest.fixture(scope='module')
def case():
    return one_stage_case(CONFIG, 0)


def test_gfl_losses_match(case):
    check_losses(case, KEYS)


def test_gfl_sgd_update_matches(case):
    check_update(case)


def test_gfl_predict_matches(case):
    # the random bins' expectations make boxes of ~8 strides a side, so
    # NMS leaves a dozen of the 50 rows
    check_predict(case, min_valid=10)


def _jax_gfl_loss(cls, reg, anchors, nla, strides, batch, c, reg_max=16):
    """`GFL.loss` of the JAX package (`gfl.py`) on given head outputs."""
    centers = jnp.stack([(anchors[:, 0] + anchors[:, 2]) * 0.5,
                         (anchors[:, 1] + anchors[:, 3]) * 0.5], -1)

    def per_image(cls_i, reg_i, gt, gtl, gtv):
        assign = jatss.atss_assign(anchors, nla, gt, gtv, gtl, 9)
        pos = assign.assigned_gt_inds > 0
        gt_m = gt[jnp.clip(assign.assigned_gt_inds - 1, 0, gt.shape[0] - 1)]
        boxes = jcoders.distance2bbox(
            centers, jgfl._dist_expectation(reg_i, reg_max) * strides[:, None])
        iou_q = jax.vmap(lambda a, b: jiou.bbox_overlaps(
            a[None], b[None])[0, 0])(boxes, gt_m)
        labels = jnp.where(pos, assign.labels, c)
        quality = jnp.where(pos, iou_q, 0.0)
        cls_l = jgfocal.quality_focal_loss(cls_i, labels, quality,
                                           reduction='sum')
        t = jcoders.bbox2distance(centers, gt_m, max_dist=float(reg_max)) / \
            strides[:, None]
        t = jnp.clip(t, 0, reg_max - 1e-3)
        dfl = jgfocal.distribution_focal_loss(
            reg_i.reshape(-1, reg_max + 1), t.reshape(-1),
            weight=jnp.repeat(pos.astype(jnp.float32), 4), reduction='sum')
        pos_f = pos.astype(jnp.float32)
        reg_l = jlosses.giou_loss(boxes, gt_m, weight=pos_f * quality,
                                  reduction='sum')
        return cls_l, reg_l, dfl, jnp.sum(pos_f), jnp.sum(pos_f * quality)

    cls_l, reg_l, dfl, npos, qsum = jax.vmap(per_image)(
        cls, reg, batch['gt_bboxes'], batch['gt_labels'], batch['gt_valid'])
    denom = jnp.maximum(jnp.sum(npos), 1.0)
    return (jnp.sum(cls_l) / denom
            + 2.0 * jnp.sum(reg_l) / jnp.maximum(jnp.sum(qsum), 1e-6)
            + 0.25 * jnp.sum(dfl) / (4.0 * denom))


@pytest.mark.parametrize('anchor_scale', [8.0, 3.0])
def test_gfl_loss_gradient_flows_through_the_quality(anchor_scale):
    """The port's `gfl_loss` and the JAX loss on the same head outputs of
    a 128x192 batch, at the COCO config's anchors and at the synth row's
    fitted ones (`anchor_scale=3`): loss within 1e-5 relative, the
    gradients of the class and bin logits within 1e-4 of their scale; a
    port loss with the quality detached misses the bin logits' gradient
    by over 100x that."""
    batch = train_batch()
    strides_l = (8, 16, 32, 64, 128)
    sizes = [(-(-128 // s), -(-192 // s)) for s in strides_l]
    anchors, nla = tanchor.level_anchors(strides_l, (1.0,), (anchor_scale,),
                                         sizes, 'cpu')
    strides = np.repeat(np.float32(strides_l), nla)
    rs = np.random.RandomState(3)
    n = anchors.shape[0]
    cls = rs.standard_normal((2, n, 4)).astype(np.float32)
    reg = (rs.standard_normal((2, n, 68)) * 2).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref, (g_cls, g_reg) = jax.value_and_grad(
        lambda a, b: _jax_gfl_loss(a, b, jnp.asarray(anchors.numpy()), nla,
                                   jnp.asarray(strides), jb, 4),
        argnums=(0, 1))(jnp.asarray(cls), jnp.asarray(reg))

    def port(detach):
        c, r = _t(cls).requires_grad_(), _t(reg).requires_grad_()
        tb = {k: _t(v) for k, v in batch.items()}
        if detach:
            orig = tgfl.aligned_iou
            tgfl.aligned_iou = lambda a, b: orig(a, b).detach()
        try:
            loss = sum(tgfl.gfl_loss(c, r, anchors, nla, _t(strides),
                                     tb['gt_bboxes'], tb['gt_labels'],
                                     tb['gt_valid'], 4).values())
        finally:
            if detach:
                tgfl.aligned_iou = orig
        return (float(loss.detach()),) + torch.autograd.grad(loss, (c, r))

    got, t_cls, t_reg = port(False)
    np.testing.assert_allclose(got, float(ref), rtol=1e-5)
    for g, r in ((t_cls, g_cls), (t_reg, g_reg)):
        r = np.asarray(r)
        scale = np.abs(r).max()
        assert np.abs(g.numpy() - r).max() <= 1e-4 * scale
    _, _, t_reg_detached = port(True)
    r = np.asarray(g_reg)
    assert np.abs(t_reg_detached.numpy() - r).max() > 1e-2 * np.abs(r).max()
