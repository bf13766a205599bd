"""Port's plain RoIAlign vs the JAX package's `batched_roi_align` (XLA) and
its Pallas `roi_align_fused` in interpret mode, on edge-case RoIs, in both
flatten orders. f32 agrees to 1e-5: both sides compute the same separable
weights and sum only the (at most 2 * sr) nonzero taps per axis, so only
summation order differs."""

import importlib
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .torch_port_utils import JAX_PKG, PORT_PKG, edge_case_rois

jra = importlib.import_module(f'{JAX_PKG}.ops.roi_align')
jpallas = importlib.import_module(f'{JAX_PKG}.ops.roi_align_pallas')
tra = importlib.import_module(f'{PORT_PKG}.ops.roi_align')


def _data(seed=0, b=2, h=6, w=9, c=16, n=24):
    rs = np.random.RandomState(seed)
    feats = rs.standard_normal((b, h, w, c)).astype(np.float32)
    return feats, edge_case_rois(rs, b, n, h, w)


@pytest.mark.parametrize('flatten', [False, True])
@pytest.mark.parametrize('out_size,sr,aligned', [(7, 2, True), (5, 3, True),
                                                 (7, 1, True),
                                                 (7, 2, False)])
def test_plain_matches_jax_xla(flatten, out_size, sr, aligned):
    feats, rois = _data()
    ref = np.asarray(jra.batched_roi_align(
        jnp.asarray(feats), jnp.asarray(rois), 1 / 16., out_size, sr,
        aligned, flatten=flatten))
    got = tra.batched_roi_align_plain(
        torch.from_numpy(feats), torch.from_numpy(rois), 1 / 16., out_size,
        sr, aligned, flatten=flatten, roi_chunk=5).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize('flatten', [False, True])
def test_plain_matches_pallas_fused_interpret(flatten):
    feats, rois = _data(seed=1, c=8)
    ref = np.asarray(jpallas.roi_align_fused(
        jnp.asarray(feats), jnp.asarray(rois), 1 / 16., 7, 2, True, 64, 8,
        True))
    if flatten:      # x-major (xbin, ybin, C)
        ref = ref.transpose(0, 1, 3, 2, 4).reshape(*ref.shape[:2], -1)
    got = tra.batched_roi_align(torch.from_numpy(feats),
                                torch.from_numpy(rois), 1 / 16., 7, 2,
                                flatten=flatten).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_plain_bf16_matches_jax_bf16():
    """bf16 rounds the weights, the x-interpolated intermediate and the
    result on both sides; one bf16 ulp of the result (2^-8 relative) is the
    tolerance."""
    feats, rois = _data(seed=2)
    ref = np.asarray(jra.batched_roi_align(
        jnp.asarray(feats, jnp.bfloat16), jnp.asarray(rois), 1 / 16.,
        flatten=True).astype(jnp.float32))
    got = tra.batched_roi_align(
        torch.from_numpy(feats).bfloat16(), torch.from_numpy(rois), 1 / 16.,
        flatten=True).float().numpy()
    np.testing.assert_allclose(got, ref, rtol=2**-7, atol=2**-7)


@pytest.mark.parametrize('flatten', [False, True])
def test_plain_backward_matches_jax_grad(flatten):
    """d feats of the port's plain version (its autograd, through
    `batched_roi_align` on the CPU) against `jax.grad` of the XLA
    `batched_roi_align` and of the Pallas `roi_align_fused` in interpret
    mode, whose backward is the `_fused_bwd` kernel. Each feature pixel sums
    a few dozen weighted cotangents in another order on each side: 1e-5 of
    the gradient's scale. rois get no gradient."""
    feats, rois = _data(seed=4, c=8)
    rs = np.random.RandomState(5)
    n = rois.shape[1]
    cot5 = rs.standard_normal((2, n, 7, 7, 8)).astype(np.float32)
    cot = cot5.transpose(0, 1, 3, 2, 4).reshape(2, n, -1) if flatten \
        else cot5

    def xla(f):
        return jnp.sum(jra.batched_roi_align(
            f, jnp.asarray(rois), 1 / 16., 7, 2, True, flatten=flatten) * cot)

    def pallas(f):
        return jnp.sum(jpallas.roi_align_fused(
            f, jnp.asarray(rois), 1 / 16., 7, 2, True, 64, 8, True) * cot5)

    ft = torch.from_numpy(feats).requires_grad_()
    rt = torch.from_numpy(rois).requires_grad_()
    out = tra.batched_roi_align(ft, rt, 1 / 16., 7, 2, flatten=flatten)
    got, grois = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                     [ft, rt], allow_unused=True)
    assert grois is None
    for fn in (xla, pallas):
        ref = np.asarray(jax.grad(fn)(jnp.asarray(feats)))
        assert np.abs(ref).max() > 1.0
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def test_cpu_dispatch_takes_plain_and_counts_nothing():
    feats, rois = _data(seed=3)
    before = tra.roi_align_pyramid_cuda.launches
    before_bwd = tra.roi_align_pyramid_bwd_cuda.launches
    ft = torch.from_numpy(feats).requires_grad_()
    out = tra.batched_roi_align(ft, torch.from_numpy(rois), 1 / 16.)
    ref = tra.batched_roi_align_plain(torch.from_numpy(feats),
                                      torch.from_numpy(rois), 1 / 16.)
    assert torch.equal(out.detach(), ref)
    out.sum().backward()
    assert tra.roi_align_pyramid_cuda.launches == before
    assert tra.roi_align_pyramid_bwd_cuda.launches == before_bwd


def test_axis_weights_rows_sum_to_valid_fraction():
    """Each bin's weights sum to the share of its samples inside
    [-1, len] (mmcv's skip rule), so padded all-zero boxes read the corner
    pixel and boxes far outside read nothing."""
    lo = torch.tensor([-0.5, -20.0, 3.2])
    bins = torch.tensor([0.0, 1.0, 0.7])
    w = tra._axis_weights(lo, bins, 7, 2, 10)
    sums = w.sum(-1)
    assert torch.allclose(sums[0], torch.ones(7))
    assert torch.equal(sums[1], torch.zeros(7))
    assert torch.allclose(sums[2], torch.ones(7))


def _chip_smoke():
    path = Path(__file__).resolve().parent.parent / 'chip_smoke.py'
    spec = importlib.util.spec_from_file_location('chip_smoke', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _brute_force_taps(rois, h, w, out_size, sr, scale):
    """Enumerate every (bin, sample, tap) of every RoI in float32: the
    pixels touched per image, the nonzero products, and the distinct
    (RoI, pixel) pairs."""
    f32 = np.float32

    def taps(lo, size, p, length):
        for s in range(sr):
            pos = f32(lo + f32(f32(p) + f32(f32(s) + f32(0.5)) / f32(sr)) *
                      size)
            valid = -1 <= pos <= length
            pc = min(max(pos, f32(0)), f32(length - 1))
            i0 = int(np.floor(pc))
            frac = f32(pc - f32(i0))
            yield i0, f32(1) - frac if valid else f32(0)
            yield min(i0 + 1, length - 1), frac if valid else f32(0)

    touched = products = pairs = 0
    for image in rois:
        image_pixels = set()
        for roi in image:
            sc = roi.astype(f32) * f32(scale)
            lo_x, lo_y = f32(sc[0] - f32(0.5)), f32(sc[1] - f32(0.5))
            bw = f32(f32(sc[2] - sc[0]) / f32(out_size))
            bh = f32(f32(sc[3] - sc[1]) / f32(out_size))
            pixels = set()
            for py in range(out_size):
                for px in range(out_size):
                    for iy, wy in taps(lo_y, bh, py, h):
                        for ix, wx in taps(lo_x, bw, px, w):
                            if wy * wx != 0:
                                products += 1
                                pixels.add((iy, ix))
            pairs += len(pixels)
            image_pixels |= pixels
        touched += len(image_pixels)
    return touched, products, pairs


@pytest.mark.parametrize('out_size,sr', [(7, 2), (5, 3)])
def test_chip_smoke_work_model_matches_brute_force(out_size, sr):
    """`chip_smoke.roi_align_taps`, the work model behind the kernels'
    bounds and the backward's atomic count, against an enumeration of every
    tap, on edge-case RoIs (border-crossing, outside, sub-pixel and zero
    boxes)."""
    rs = np.random.RandomState(6)
    rois = edge_case_rois(rs, 2, 12, 6, 9)
    got = _chip_smoke().roi_align_taps(list(torch.from_numpy(rois)), 6, 9,
                                       out_size, sr)
    want = _brute_force_taps(rois, 6, 9, out_size, sr, 1 / 16)
    assert got == want
    assert 0 < want[2] < want[1]        # shared pixels merge in the pairs
