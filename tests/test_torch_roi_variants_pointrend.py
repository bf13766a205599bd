"""PointRend against the JAX package (`configs/point_rend/point_rend_r50_
fpn_1x.py` with an R18 trunk, 4 classes and 32 RoIs an image, as
`test_torch_roi_variants.variant_case` builds it, with seeded 28x28
box-frame rasters): one train step and `predict` (the refined masks) from
the same weights; then its choice of points where the coarse logits tie,
and the point loss's gradient into the mask head. Tolerances as in
`test_torch_roi_variants.py`.

The weight seed is one whose served coarse masks hold no near-tie at the
cutoff of the 196 most uncertain points: the two sides' logits differ by
rounding, and where two pixels' |logit| lie within it at the cutoff the
sides refine different ones (at seeds 1–3 and 7 one or more rows do, up
to 0.13 apart in a pixel; at 4–6 none).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest

from .test_torch_cascade import check_losses, check_predict, check_update
from .test_torch_roi_variants import (BOX_KEYS, CONFIGS, JAX_PKG, ROOT, TINY,
                                      jbuilder, jconfig, tvariants,
                                      variant_case, _t)
from .test_torch_roi_variants_masks import mask_head_gradients

jvariants = importlib.import_module(
    f'{JAX_PKG}.models.detectors.roi_variants')

POINT_REND_SEED = 6
POINT_KEYS = BOX_KEYS | {'loss_mask', 'loss_point'}


@pytest.fixture(scope='module')
def case():
    return variant_case('PointRend', POINT_REND_SEED)


def test_point_rend_losses_match(case):
    check_losses(case, POINT_KEYS)


def test_point_rend_sgd_update_matches(case):
    check_update(case)


def test_point_rend_predict_matches(case):
    check_predict(case, True)


def test_point_loss_trains_the_mask_head(case):
    """The coarse logits are sampled at the points with their gradient (the
    points themselves come from stopped logits), so `loss_point` alone
    reaches every layer of the mask head, as in JAX."""
    assert all(float(g.abs().max()) > 0
               for g in mask_head_gradients(case, 'loss_point'))


def _jax_point_rend():
    jcfg = jconfig.Config.fromfile(str(ROOT / CONFIGS['PointRend']))
    jcfg.merge_from_dict(TINY)
    return jbuilder.build_detector(jcfg.model)


def test_point_choice_on_tied_logits_follows_jax_top_k():
    """Where the own-class coarse logits tie (a padded RoI's all-equal
    map, repeated values, |+x| = |-x|), the points are the ones JAX's
    `top_k` takes, the lower index first; and on distinct logits too."""
    jmodel = _jax_point_rend()
    rs = np.random.RandomState(0)
    logits = rs.standard_normal((2, 3, 28, 28, 4)).astype(np.float32)
    logits[0, 0] = 0.25                                   # all tied
    logits[0, 1, :, :, 2] = np.round(logits[0, 1, :, :, 2] * 2) / 2
    logits[1, 0, ::2, :, 1] = -logits[1, 0, 1::2, :, 1]   # |x| pairs
    labels = np.array([[0, 2, 4], [1, 3, 2]], np.int32)  # 4: background
    ref_pts, ref_idx = jvariants.PointRend._point_coords(
        jmodel, jnp.asarray(logits), jnp.asarray(labels))
    port = tvariants.PointRend.__new__(tvariants.PointRend)
    port.num_classes, port.num_points = 4, jmodel.num_points
    pts, idx = port.point_coords(_t(logits), _t(labels))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(pts.numpy(), np.asarray(ref_pts))
    assert idx.shape == (2, 3, 196)
    np.testing.assert_array_equal(idx[0, 0].numpy(), np.arange(196))
