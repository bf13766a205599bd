"""The port's multi-level (FPN) RoIAlign against the JAX package's: the
level of each RoI (exact), the plain version against `batched_roi_align_fpn`
(XLA) and the Pallas `roi_align_fpn_fused_v2` in interpret mode, forward in
f32 and bf16 and the gradient, at o=7 (boxes) and o=14 (masks), on RoIs
spread over all four levels of a 512x640 canvas.

Tolerances: f32 within 1e-5 of the output's scale (both sides compute the
same separable weights and sum the same few nonzero taps in another order);
bf16 within 2e-2 of scale (each side rounds weights, intermediate and
result at its own places).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .torch_port_utils import JAX_PKG, PORT_PKG

jra = importlib.import_module(f'{JAX_PKG}.ops.roi_align')
jpallas = importlib.import_module(f'{JAX_PKG}.ops.roi_align_pallas')
tra = importlib.import_module(f'{PORT_PKG}.ops.roi_align')

STRIDES = (4, 8, 16, 32)
CANVAS = (512, 640)


def _pyramid(rs, b=2, c=8, levels=5):
    h, w = CANVAS
    return [rs.standard_normal((b, -(-h // 2**(i + 2)), -(-w // 2**(i + 2)),
                                c)).astype(np.float32)
            for i in range(levels)]


def _fpn_rois(rs, b=2, n=40):
    """RoIs over the canvas whose sizes spread over the four levels (sqrt
    area 8..700 px, log-uniform), with boxes crossing and beyond the
    border, under one pixel, zero (padded) and at the exact level
    boundaries sqrt(area) = 112, 224, 448."""
    h, w = CANVAS
    side = np.exp(rs.uniform(np.log(8), np.log(700), (b, n)))
    aspect = np.exp(rs.uniform(-0.7, 0.7, (b, n)))
    bw, bh = side * aspect, side / aspect
    x1 = rs.uniform(-0.1 * w, w - 0.5 * bw)
    y1 = rs.uniform(-0.1 * h, h - 0.5 * bh)
    rois = np.stack([x1, y1, x1 + bw, y1 + bh], -1)
    special = np.array([
        [0, 0, 0, 0],
        [10, 20, 122, 132],                # sqrt area 112
        [100, 50, 324, 274],               # 224
        [30, 40, 478, 488],                # 448
        [0, 0, 896, 224],                  # 448, elongated, past the border
        [-40, -30, 60, 50],
        [w - 20, h - 30, w + 200, h + 100],
        [w + 10, h + 10, w + 90, h + 60],  # beyond
        [5.3, 7.1, 5.9, 7.4],
    ], np.float64)
    rois[:, :len(special)] = special
    return rois.astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close_scaled(got, ref, tol):
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


def _xmajor(x5):
    """(B, R, o, o, C) → (B, R, o·o·C) in x-major order."""
    return x5.transpose(0, 1, 3, 2, 4).reshape(*x5.shape[:2], -1)


def test_roi_levels_match_jax_exactly():
    rs = np.random.RandomState(0)
    sides = np.concatenate([
        [0, 55.99, 56, 111.999, 112, 112.001, 224, 448, 448.0001, 1e5],
        rs.uniform(0, 1200, 20000)]).astype(np.float32)
    squares = np.stack([np.zeros_like(sides), np.zeros_like(sides), sides,
                        sides], -1)
    rects = np.array([[10, 20, 10 + 224, 20 + 896], [3, 5, 115, 117],
                      [0, 0, 896, 224], [5, 5, 1, 9], [4, 4, 4, 500]],
                     np.float32)
    for rois in (squares[None], rects[None], _fpn_rois(rs)):
        ref = np.asarray(jra.roi_levels(jnp.asarray(rois), 4))
        got = tra.roi_levels(_t(rois), 4)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)
    lv = tra.roi_levels(_t(squares[None]), 4)[0, :10].tolist()
    assert lv == [0, 0, 0, 0, 1, 1, 2, 3, 3, 3]
    assert set(tra.roi_levels(_t(_fpn_rois(rs)), 4).unique().tolist()) == \
        {0, 1, 2, 3}


@pytest.mark.parametrize('out_size', [7, 14])
def test_plain_fpn_matches_jax_xla(out_size):
    rs = np.random.RandomState(1)
    feats, rois = _pyramid(rs), _fpn_rois(rs)
    ref = np.asarray(jra.batched_roi_align_fpn(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois), STRIDES,
        out_size))
    tfeats = [_t(f) for f in feats]
    got = tra.batched_roi_align_fpn(tfeats, _t(rois), STRIDES, out_size)
    assert got.shape == ref.shape
    _close_scaled(got.numpy(), ref, 1e-5)
    flat = tra.batched_roi_align_fpn(tfeats, _t(rois), STRIDES, out_size,
                                     flatten=True)
    _close_scaled(flat.numpy(), _xmajor(ref), 1e-5)


@pytest.mark.parametrize('out_size', [7, 14])
def test_plain_fpn_matches_pallas_v2_interpret(out_size):
    rs = np.random.RandomState(2)
    feats, rois = _pyramid(rs), _fpn_rois(rs, n=24)
    ref = np.asarray(jpallas.roi_align_fpn_fused_v2(
        tuple(jnp.asarray(f) for f in feats), jnp.asarray(rois), STRIDES,
        out_size, 2, True, 56, 64, 8, True))
    got = tra.batched_roi_align_fpn([_t(f) for f in feats], _t(rois),
                                    STRIDES, out_size, flatten=True)
    _close_scaled(got.numpy(), _xmajor(ref), 1e-5)


def test_plain_fpn_bf16_matches_jax_bf16():
    """In bf16 the port's plain version rounds where the JAX XLA form does
    (weights, x-interpolated intermediate, result); the Pallas v2 kernel
    keeps the intermediate in f32. Both within 2e-2 of scale."""
    rs = np.random.RandomState(3)
    feats, rois = _pyramid(rs), _fpn_rois(rs, n=24)
    jfeats = tuple(jnp.asarray(f, jnp.bfloat16) for f in feats)
    refs = [jra.batched_roi_align_fpn(jfeats, jnp.asarray(rois), STRIDES),
            jpallas.roi_align_fpn_fused_v2(jfeats, jnp.asarray(rois), STRIDES,
                                           7, 2, True, 56, 64, 8, True)]
    got = tra.batched_roi_align_fpn([_t(f).bfloat16() for f in feats],
                                    _t(rois), STRIDES)
    assert got.dtype == torch.bfloat16
    for ref in refs:
        _close_scaled(got.float().numpy(),
                      np.asarray(ref.astype(jnp.float32)), 2e-2)


def test_plain_fpn_gradient_matches_jax_grad():
    """d feats of the port's plain version (its autograd) against
    `jax.grad` of the XLA `batched_roi_align_fpn` and of the Pallas
    `roi_align_fpn_fused_v2` in interpret mode (its backward is the
    `_fpn2_fused_bwd` kernel), over a five-level pyramid: every level
    within 1e-5 of the gradient's scale, P6 and the rois get nothing."""
    rs = np.random.RandomState(4)
    feats, rois = _pyramid(rs), _fpn_rois(rs, n=24)
    cot5 = rs.standard_normal((2, 24, 7, 7, 8)).astype(np.float32)

    def xla(fs):
        return jnp.sum(jra.batched_roi_align_fpn(
            fs, jnp.asarray(rois), STRIDES) * cot5)

    def pallas(fs):
        return jnp.sum(jpallas.roi_align_fpn_fused_v2(
            fs, jnp.asarray(rois), STRIDES, 7, 2, True, 56, 64, 8, True)
            * cot5)

    tf = [_t(f).requires_grad_() for f in feats]
    rt = _t(rois).requires_grad_()
    out = tra.batched_roi_align_fpn(tf, rt, STRIDES, flatten=True)
    got = torch.autograd.grad((out * _t(_xmajor(cot5))).sum(), [*tf, rt],
                              allow_unused=True)
    assert got[4] is None and got[5] is None          # P6, rois
    for fn in (xla, pallas):
        ref = jax.grad(fn)(tuple(jnp.asarray(f) for f in feats))
        assert not np.asarray(ref[4]).any()
        for lvl in range(4):
            r = np.asarray(ref[lvl])
            assert np.abs(r).max() > 0.5, lvl
            _close_scaled(got[lvl].numpy(), r, 1e-5)


def test_cpu_dispatch_takes_plain_and_counts_nothing():
    rs = np.random.RandomState(5)
    feats, rois = _pyramid(rs, levels=4), _fpn_rois(rs, n=12)
    before = (tra.roi_align_pyramid_cuda.launches,
              tra.roi_align_pyramid_bwd_cuda.launches)
    tf = [_t(f).requires_grad_() for f in feats]
    out = tra.batched_roi_align_fpn(tf, _t(rois))
    ref = tra.batched_roi_align_fpn_plain([_t(f) for f in feats], _t(rois))
    assert torch.equal(out.detach(), ref)
    out.sum().backward()
    assert (tra.roi_align_pyramid_cuda.launches,
            tra.roi_align_pyramid_bwd_cuda.launches) == before
    with pytest.raises(ValueError, match='strides'):
        tra.batched_roi_align_fpn(tf[:3], _t(rois))
