"""The port's CUDA kernels against their plain versions, on a card.

These need a CUDA card and `nvcc` (they skip without a card) and import
nothing of JAX, so they run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.ops import \
    roi_align as ra

from .torch_port_utils import edge_case_rois


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _data(device, dtype, b=2, h=9, w=13, c=40, n=30, seed=0):
    rs = np.random.RandomState(seed)
    feats = torch.from_numpy(rs.standard_normal((b, h, w, c)).astype(
        np.float32)).to(device, dtype)
    rois = torch.from_numpy(edge_case_rois(rs, b, n, h, w)).to(device)
    return feats, rois


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize('c', [40, 37])     # vectorized and scalar paths
@pytest.mark.parametrize('flatten', [False, True])
@pytest.mark.parametrize('out_size,sr,aligned', [(7, 2, True), (5, 3, True),
                                                 (7, 2, False)])
def test_roi_align_kernel_matches_plain(cuda, dtype, tol, c, flatten,
                                        out_size, sr, aligned):
    feats, rois = _data(cuda, dtype, c=c)
    before = ra.batched_roi_align.launches
    got = ra.batched_roi_align(feats, rois, 1 / 16, out_size, sr, aligned,
                               flatten)
    assert ra.batched_roi_align.launches == before + 1
    ref = ra.batched_roi_align_plain(feats, rois, 1 / 16, out_size, sr,
                                     aligned, flatten)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == dtype
    scale = max(1.0, float(ref.float().abs().max()))
    assert float((got.float() - ref.float()).abs().max()) <= tol * scale


@pytest.mark.cuda
def test_roi_align_kernel_refuses_what_it_does_not_take(cuda):
    """Forward and backward kernels raise on what they do not take; a
    feature map that needs a gradient is taken (the training path)."""
    feats, rois = _data(cuda, torch.float32)
    out = ra.batched_roi_align(feats.clone().requires_grad_(), rois, 1 / 16)
    assert out.requires_grad
    shape = tuple(feats.shape)
    g = torch.zeros(out.shape, device=cuda)
    with pytest.raises(ValueError):
        ra.roi_align_bwd_cuda(g[:, :, :6], rois, shape, 1 / 16)
    with pytest.raises(TypeError):
        ra.roi_align_bwd_cuda(g.half(), rois, shape, 1 / 16)
    with pytest.raises(ValueError):
        ra.roi_align_bwd_cuda(g.transpose(2, 3), rois, shape, 1 / 16)
    with pytest.raises(ValueError):
        ra.roi_align_bwd_cuda(g, rois.cpu(), shape, 1 / 16)
    with pytest.raises(TypeError):
        ra.batched_roi_align(feats.half(), rois, 1 / 16)
    with pytest.raises(ValueError):
        ra.batched_roi_align(feats.transpose(1, 2), rois, 1 / 16)
    with pytest.raises(ValueError):
        ra.batched_roi_align(feats, rois.cpu(), 1 / 16)
    with pytest.raises(ValueError):
        ra.batched_roi_align(feats, rois, 1 / 16, out_size=33,
                             sampling_ratio=2)


def _plain_grad(feats, rois, cot, out_size, sr, aligned, flatten):
    f = feats.detach().clone().requires_grad_()
    out = ra.batched_roi_align_plain(f, rois, 1 / 16, out_size, sr, aligned,
                                     flatten)
    (grad,) = torch.autograd.grad(out, f, cot)
    return grad


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize('c', [40, 37])     # vectorized and scalar paths
@pytest.mark.parametrize('flatten', [False, True])
@pytest.mark.parametrize('out_size,sr,aligned', [(7, 2, True), (5, 3, True),
                                                 (7, 2, False)])
def test_roi_align_bwd_kernel_matches_plain(cuda, dtype, tol, c, flatten,
                                            out_size, sr, aligned):
    """`roi_align_bwd` against the plain version's autograd. The kernel
    adds its taps with f32 atomics in an order that changes from run to
    run: f32 within 1e-5 of the gradient's scale; bf16 (the plain version
    rounds weights and intermediates to bf16) within 2e-2."""
    feats, rois = _data(cuda, dtype, c=c)
    shape = (2, rois.shape[1], out_size * out_size * c) if flatten else \
        (2, rois.shape[1], out_size, out_size, c)
    gen = torch.Generator(device=cuda).manual_seed(1)
    cot = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    before = ra.roi_align_bwd_cuda.launches
    got = ra.roi_align_bwd_cuda(cot, rois, tuple(feats.shape), 1 / 16,
                                out_size, sr, aligned, flatten)
    assert ra.roi_align_bwd_cuda.launches == before + 1
    ref = _plain_grad(feats, rois, cot, out_size, sr, aligned, flatten)
    torch.cuda.synchronize()
    assert got.shape == feats.shape and got.dtype == dtype
    scale = max(1.0, float(ref.float().abs().max()))
    assert float((got.float() - ref.float()).abs().max()) <= tol * scale


@pytest.mark.cuda
def test_roi_align_function_under_autograd(cuda):
    """`batched_roi_align` on a CUDA tensor that needs a gradient goes
    through `RoIAlignFunction`: one forward and one backward launch, the
    plain version's gradient within 1e-5 of scale, none for the rois; under
    `no_grad` it is the plain forward launch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    feats, rois = _data(cuda, torch.float32)
    f = feats.clone().requires_grad_()
    fwd, bwd = ra.batched_roi_align.launches, ra.roi_align_bwd_cuda.launches
    out = ra.batched_roi_align(f, rois.requires_grad_(), 1 / 16,
                               flatten=True)
    cot = torch.randn_like(out)
    (out * cot).sum().backward()
    assert ra.batched_roi_align.launches == fwd + 1
    assert ra.roi_align_bwd_cuda.launches == bwd + 1
    assert rois.grad is None
    ref = _plain_grad(feats, rois.detach(), cot, 7, 2, True, True)
    scale = max(1.0, float(ref.abs().max()))
    assert float((f.grad - ref).abs().max()) <= 1e-5 * scale
    with torch.no_grad():
        ra.batched_roi_align(f, rois, 1 / 16)
    assert ra.batched_roi_align.launches == fwd + 2
    assert ra.roi_align_bwd_cuda.launches == bwd + 1


def _pyramid(device, dtype, b=2, c=40, seed=0, n=36):
    """Four levels of a 160x224 canvas and RoIs whose sizes reach every
    level (sqrt area 8..700 px, one of 500), with the edge cases of
    `edge_case_rois`."""
    rs = np.random.RandomState(seed)
    feats = [torch.from_numpy(rs.standard_normal(
        (b, -(-160 // s), -(-224 // s), c)).astype(np.float32)).to(
            device, dtype) for s in (4, 8, 16, 32)]
    rois = edge_case_rois(rs, b, n, 10, 14)
    side = np.exp(rs.uniform(np.log(8), np.log(700), (b, n - 8)))
    rois[:, 8:, 2:] = rois[:, 8:, :2] + side[..., None]
    rois[:, 8] = [0, 0, 500, 500]
    rois = torch.from_numpy(rois).to(device)
    assert set(ra.roi_levels(rois, 4).unique().tolist()) == {0, 1, 2, 3}
    return feats, rois


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize('c', [40, 37])     # vectorized and scalar paths
@pytest.mark.parametrize('flatten', [False, True])
@pytest.mark.parametrize('out_size', [7, 14])
def test_roi_align_fpn_kernels_match_plain(cuda, dtype, tol, c, flatten,
                                           out_size):
    """`roi_align_fpn_fwd` against the plain multi-level version, and
    `roi_align_fpn_bwd` against its autograd (f32 atomics in an order that
    changes from run to run): f32 within 1e-5 of scale, bf16 within 2e-2;
    one launch each."""
    feats, rois = _pyramid(cuda, dtype, c=c)
    levels = ra.roi_levels(rois, 4)
    before = ra.roi_align_fpn_cuda.launches
    got = ra.roi_align_fpn_cuda(feats, rois, levels, out_size=out_size,
                                flatten=flatten)
    assert ra.roi_align_fpn_cuda.launches == before + 1
    fs = [f.detach().clone().requires_grad_() for f in feats]
    ref = ra.batched_roi_align_fpn_plain(fs, rois, out_size=out_size,
                                         flatten=flatten)
    assert got.shape == ref.shape and got.dtype == dtype
    scale = max(1.0, float(ref.detach().float().abs().max()))
    assert float((got.float() - ref.detach().float()).abs().max()) <= \
        tol * scale

    gen = torch.Generator(device=cuda).manual_seed(1)
    cot = torch.randn(ref.shape, generator=gen, device=cuda).to(dtype)
    before = ra.roi_align_fpn_bwd_cuda.launches
    grads = ra.roi_align_fpn_bwd_cuda(cot, rois, levels,
                                      [f.shape for f in feats],
                                      out_size=out_size, flatten=flatten)
    assert ra.roi_align_fpn_bwd_cuda.launches == before + 1
    refs = torch.autograd.grad(ref, fs, cot)
    torch.cuda.synchronize()
    for g, r in zip(grads, refs):
        assert g.shape == r.shape and g.dtype == dtype
        scale = max(1.0, float(r.float().abs().max()))
        assert float((g.float() - r.float()).abs().max()) <= tol * scale


@pytest.mark.cuda
def test_roi_align_fpn_function_under_autograd(cuda):
    """`batched_roi_align_fpn` on CUDA maps that need a gradient: one
    forward and one backward launch, a fifth level ignored (no gradient),
    none for the rois; under `no_grad` only the forward launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    feats, rois = _pyramid(cuda, torch.float32)
    fs = [f.clone().requires_grad_() for f in feats]
    p6 = torch.zeros(2, 3, 4, 40, device=cuda, requires_grad=True)
    fwd = ra.roi_align_fpn_cuda.launches
    bwd = ra.roi_align_fpn_bwd_cuda.launches
    out = ra.batched_roi_align_fpn([*fs, p6], rois.requires_grad_(),
                                   flatten=True)
    cot = torch.randn_like(out)
    (out * cot).sum().backward()
    assert ra.roi_align_fpn_cuda.launches == fwd + 1
    assert ra.roi_align_fpn_bwd_cuda.launches == bwd + 1
    assert rois.grad is None and p6.grad is None
    plain = [f.detach().clone().requires_grad_() for f in feats]
    refs = torch.autograd.grad(ra.batched_roi_align_fpn_plain(
        plain, rois.detach(), flatten=True), plain, cot)
    for f, r in zip(fs, refs):
        scale = max(1.0, float(r.abs().max()))
        assert float((f.grad - r).abs().max()) <= 1e-5 * scale
    with torch.no_grad():
        ra.batched_roi_align_fpn(fs, rois)
    assert ra.roi_align_fpn_cuda.launches == fwd + 2
    assert ra.roi_align_fpn_bwd_cuda.launches == bwd + 1


@pytest.mark.cuda
def test_roi_align_fpn_kernels_refuse_what_they_do_not_take(cuda):
    feats, rois = _pyramid(cuda, torch.float32)
    levels = ra.roi_levels(rois, 4)
    shapes = [f.shape for f in feats]
    g = torch.zeros(2, rois.shape[1], 7, 7, 40, device=cuda)
    with pytest.raises(ValueError):               # a CPU tensor
        ra.roi_align_fpn_cuda([feats[0].cpu(), *feats[1:]], rois, levels)
    with pytest.raises(ValueError):
        ra.roi_align_fpn_cuda(feats, rois.cpu(), levels)
    with pytest.raises(ValueError):
        ra.roi_align_fpn_bwd_cuda(g.cpu(), rois, levels, shapes)
    with pytest.raises(TypeError):                # an unsupported dtype
        ra.roi_align_fpn_cuda([f.half() for f in feats], rois, levels)
    with pytest.raises(TypeError):
        ra.roi_align_fpn_bwd_cuda(g.half(), rois, levels, shapes)
    with pytest.raises(ValueError):               # o * sr > 64
        ra.roi_align_fpn_cuda(feats, rois, levels, out_size=33)
    with pytest.raises(ValueError):
        ra.roi_align_fpn_bwd_cuda(g, rois, levels, shapes, out_size=7,
                                  sampling_ratio=10)
    with pytest.raises(ValueError):               # levels not int32
        ra.roi_align_fpn_cuda(feats, rois, levels.long())
    with pytest.raises(ValueError):               # not NHWC-contiguous
        ra.roi_align_fpn_cuda([f.transpose(1, 2) for f in feats], rois,
                              levels)
    with pytest.raises(ValueError):               # strides and levels
        ra.roi_align_fpn_cuda(feats[:3], rois, levels)
