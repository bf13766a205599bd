"""HTC and SCNet against the JAX package: their heads (the information-flow
mask head, the fused semantic head at a canvas whose level ratios are not
whole numbers, the global-context and feature-relay heads), the nearest
resize, the semantic RoI pool of one stride-8 map given as four pyramid
levels (forward and gradient), then one train step and `predict` of each
tiny detector (`configs/htc/htc_r50_fpn_1x.py` and
`configs/scnet/scnet_r50_fpn_1x.py`, semantic branch on, with an R18
trunk, 4 classes and 32 RoIs a stage; `test_torch_cascade.cascade_case`).
The HTC batch carries a `gt_semantic_seg` map, so `loss_semantic` is
held; SCNet computes no semantic loss, so its semantic logits get no
gradient and only weight decay moves them, on both sides.

Tolerances: heads and the pool within 1e-5 of the output's scale (the same
f32 arithmetic in another order), the nearest resize exact; the steps and
`predict` as in `test_torch_cascade.py`.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .test_torch_cascade import (BOX_KEYS, cascade_case, check_losses,
                                 check_predict, check_update)
from .torch_port_utils import JAX_PKG, PORT_PKG, edge_case_rois, fill_variables

jhtc = importlib.import_module(f'{JAX_PKG}.models.detectors.htc')
jscnet = importlib.import_module(f'{JAX_PKG}.models.detectors.scnet')
jroi = importlib.import_module(f'{JAX_PKG}.models.roi_heads.standard_roi_head')
thtc = importlib.import_module(f'{PORT_PKG}.models.detectors.htc')
tscnet = importlib.import_module(f'{PORT_PKG}.models.detectors.scnet')
troi = importlib.import_module(f'{PORT_PKG}.ops.roi_align')
convert = importlib.import_module(f'{PORT_PKG}.utils.convert')


def _close_scaled(got, ref, tol=1e-5):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=tol * scale)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(
        0, 3, 1, 2)))


def _module(jmodule, tmodule, rs, *inputs):
    """Carry `jmodule`'s seeded variables into `tmodule`."""
    shapes = jax.eval_shape(lambda: jmodule.init(jax.random.PRNGKey(0),
                                                 *inputs))
    variables = fill_variables(shapes, rs)
    assert convert.load_jax_variables(tmodule, variables) == []
    return variables


@pytest.mark.parametrize('m,n', [(200, 100), (336, 168), (13, 100),
                                 (21, 168), (25, 13), (38, 19), (7, 13),
                                 (5, 19), (128, 16), (100, 13)])
def test_nearest_resize_matches_jax(m, n):
    """Half-pixel nearest with JAX's float32 positions, exact: the semantic
    head's 2x downsample of P2 and upsamples of P4–P6 at 800x1344 (P6 is
    13x21) and at an odd canvas, and the label map's integer resize."""
    x = np.arange(2 * m * 3).reshape(2, m, 3).astype(np.int32)
    ref = jax.image.resize(jnp.asarray(x), (2, n, 3), method='nearest')
    got = thtc.resize_nearest(torch.from_numpy(x), (n, 3), dims=(1, 2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_fused_semantic_head_at_an_odd_canvas():
    """The pyramid of a 100x150 image (P2 25x38 … P6 2x3): every resize to
    P3's 13x19 has a ratio that is not a whole number."""
    rs = np.random.RandomState(0)
    sizes = [(25, 38), (13, 19), (7, 10), (4, 5), (2, 3)]
    feats = [rs.standard_normal((2, h, w, 8)).astype(np.float32)
             for h, w in sizes]
    jm = jhtc.FusedSemanticHead(num_classes=5, conv_out=8)
    tm = thtc.FusedSemanticHead(num_classes=5, in_channels=8, conv_out=8)
    variables = _module(jm, tm, rs, [jnp.asarray(f) for f in feats])
    ref_logits, ref_feat = jm.apply(variables, [jnp.asarray(f) for f in feats])
    logits, feat = tm([_nchw(f) for f in feats])
    assert tuple(logits.shape) == (2, 5, 13, 19)
    _close_scaled(logits.detach().numpy().transpose(0, 2, 3, 1), ref_logits)
    _close_scaled(feat.detach().numpy().transpose(0, 2, 3, 1), ref_feat)


@pytest.mark.parametrize('info_flow', [False, True])
def test_htc_mask_head_matches_jax(info_flow):
    """Logits (the nearest 2x upsample inside) and the feature that flows
    to the next stage."""
    rs = np.random.RandomState(int(info_flow))
    x = rs.standard_normal((2, 5, 7, 7, 8)).astype(np.float32)
    last = rs.standard_normal((2, 5, 7, 7, 16)).astype(np.float32) \
        if info_flow else None
    jm = jhtc.HTCMaskHead(num_classes=3, conv_out=16)
    tm = thtc.HTCMaskHead(num_classes=3, in_channels=8, conv_out=16,
                          info_flow=info_flow)
    args = (jnp.asarray(x),) + ((jnp.asarray(last),) if info_flow else ())
    variables = _module(jm, tm, rs, *args)
    ref, ref_feat = jm.apply(variables, *args)
    t_last = None if last is None else _nchw(last.reshape(10, 7, 7, 16))
    got, feat = tm(torch.from_numpy(x), t_last)
    assert tuple(got.shape) == ref.shape == (2, 5, 14, 14, 3)
    _close_scaled(got.detach().numpy(), ref)
    _close_scaled(feat.detach().numpy().transpose(0, 2, 3, 1),
                  np.asarray(ref_feat).reshape(10, 7, 7, 16))


def test_global_context_head_matches_jax():
    rs = np.random.RandomState(2)
    feats = [rs.standard_normal((2, 9, 11, 8)).astype(np.float32),
             rs.standard_normal((2, 3, 5, 8)).astype(np.float32)]
    jm = jscnet.GlobalContextHead(num_classes=4, conv_out=8, fc_out=12)
    tm = tscnet.GlobalContextHead(num_classes=4, in_channels=8, conv_out=8,
                                  fc_out=12)
    variables = _module(jm, tm, rs, [jnp.asarray(f) for f in feats])
    ref_logits, ref_feat = jm.apply(variables, [jnp.asarray(f) for f in feats])
    logits, feat = tm([_nchw(f) for f in feats])
    _close_scaled(logits.detach().numpy(), ref_logits)
    _close_scaled(feat.detach().numpy(), ref_feat)


def test_feature_relay_head_matches_jax():
    """The Dense output read as (y, x, C), then the bilinear 7 → 14 resize,
    borders included."""
    rs = np.random.RandomState(3)
    shared = rs.standard_normal((2, 5, 16)).astype(np.float32)
    jm = jscnet.FeatRelayHead(roi_size=14, out_channels=6)
    tm = tscnet.FeatRelayHead(in_channels=16, roi_size=14, out_channels=6)
    variables = _module(jm, tm, rs, jnp.asarray(shared))
    ref = jm.apply(variables, jnp.asarray(shared))
    got = tm(torch.from_numpy(shared))
    assert tuple(got.shape) == ref.shape == (2, 5, 14, 14, 6)
    _close_scaled(got.detach().numpy(), ref)


@pytest.mark.parametrize('out_size', [7, 14])
def test_semantic_pool_of_one_map_as_four_levels(out_size):
    """`extract_roi_feats_fpn((m,) * 5, rois)` of the JAX package against
    the port's pool of the same map given as its four levels: RoIs of every
    level (a level-0 RoI samples the map at twice its scale, samples past
    it add zero), forward, and the gradient, which sums the four levels'
    terms into the one map."""
    rs = np.random.RandomState(7)
    m = rs.standard_normal((2, 13, 19, 8)).astype(np.float32)
    rois = np.concatenate([edge_case_rois(rs, 2, 12, 13, 19, stride=8),
                           edge_case_rois(rs, 2, 12, 13, 19, stride=64)], 1)
    w = rs.standard_normal((2, 24, out_size, out_size, 8)).astype(np.float32)
    levels = troi.roi_levels(torch.from_numpy(rois), 4).numpy()
    assert set(np.unique(levels)) == {0, 1, 2, 3}

    def jfn(mm):
        return jroi.extract_roi_feats_fpn((mm,) * 5, jnp.asarray(rois),
                                          out_size=out_size)
    ref, vjp = jax.vjp(jax.jit(jfn), jnp.asarray(m))
    ref_grad, = vjp(jnp.asarray(w))
    tm = torch.from_numpy(m).requires_grad_()
    got = troi.batched_roi_align_fpn((tm,) * 4, torch.from_numpy(rois),
                                     out_size=out_size)
    (got * torch.from_numpy(w)).sum().backward()
    _close_scaled(got.detach().numpy(), ref)
    _close_scaled(tm.grad.numpy(), ref_grad)
    assert np.abs(np.asarray(ref_grad)).max() > 0


SEMANTIC = dict(gt_semantic_seg=np.where(
    np.random.RandomState(8).uniform(size=(2, 128, 192)) < 0.1, 255,
    np.random.RandomState(7).randint(0, 183, (2, 128, 192))).astype(
        np.int32))
MASK_KEYS = {f's{i}.loss_mask' for i in range(3)}
# (weight seed, extra batch keys, loss keys besides the box cascade's)
CASES = {'HTC': (4, SEMANTIC, MASK_KEYS | {'loss_semantic'}),
         'SCNet': (2, {}, {'loss_glbctx', 'loss_mask'})}


@pytest.fixture(scope='module', params=sorted(CASES))
def case(request):
    seed, extra, _ = CASES[request.param]
    return request.param, cascade_case(request.param, seed, extra)


def test_htc_scnet_losses_match(case):
    name, c = case
    check_losses(c, BOX_KEYS | CASES[name][2])


def test_htc_scnet_sgd_update_matches(case):
    """The update as in `test_torch_cascade.py`; SCNet's semantic logits
    move by weight decay alone (no loss reads them)."""
    name, c = case
    check_update(c)
    if name == 'SCNet':
        state, wd = c['state'], c['trainer'].spec.weight_decay
        start = convert.from_jax_variables(c['variables'],
                                           c['trainer'].model)[0]
        for n in ('weight', 'bias'):
            k = f'semantic_head.logits.{n}'
            np.testing.assert_allclose(state.opt_state.momentum[k].numpy(),
                                       wd * start[k].numpy(), rtol=1e-6)


def test_htc_scnet_predict_matches(case):
    check_predict(case[1], with_masks=True)
