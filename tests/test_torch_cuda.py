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
