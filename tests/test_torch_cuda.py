"""The port's CUDA kernels against their plain versions, on a card.

These need a CUDA card and `nvcc` (they skip without a card) and import
nothing of JAX, so they run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import pathlib

import numpy as np
import pytest
import torch

from unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.ops import \
    roi_align as ra

from .torch_port_utils import edge_case_rois

ONE = (1 / 16,)                    # the single-level path: stride 16
SCALES = (1 / 4, 1 / 8, 1 / 16, 1 / 32)


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
# vectorised, scalar, and two f32 vectors a thread (C / 8 >= 64)
@pytest.mark.parametrize('c', [40, 37, 512])
@pytest.mark.parametrize('flatten', [False, True])
@pytest.mark.parametrize('out_size,sr,aligned', [(7, 2, True), (5, 3, True),
                                                 (7, 2, False)])
def test_roi_align_kernel_matches_plain(cuda, dtype, tol, c, flatten,
                                        out_size, sr, aligned):
    feats, rois = _data(cuda, dtype, c=c)
    before = ra.roi_align_pyramid_cuda.launches
    got = ra.batched_roi_align(feats, rois, 1 / 16, out_size, sr, aligned,
                               flatten)
    assert ra.roi_align_pyramid_cuda.launches == before + 1
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
    shapes = [tuple(feats.shape)]
    g = torch.zeros(out.shape, device=cuda)
    with pytest.raises(ValueError):
        ra.roi_align_pyramid_bwd_cuda(g[:, :, :6], rois, None, shapes, ONE)
    with pytest.raises(TypeError):
        ra.roi_align_pyramid_bwd_cuda(g.half(), rois, None, shapes, ONE)
    with pytest.raises(ValueError):
        ra.roi_align_pyramid_bwd_cuda(g.transpose(2, 3), rois, None, shapes,
                                      ONE)
    with pytest.raises(ValueError):
        ra.roi_align_pyramid_bwd_cuda(g, rois.cpu(), None, shapes, ONE)
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
    """The backward kernel at one level against the plain version's
    autograd. The kernel
    adds its taps with f32 atomics in an order that changes from run to
    run: f32 within 1e-5 of the gradient's scale; bf16 (the plain version
    rounds weights and intermediates to bf16) within 2e-2."""
    feats, rois = _data(cuda, dtype, c=c)
    shape = (2, rois.shape[1], out_size * out_size * c) if flatten else \
        (2, rois.shape[1], out_size, out_size, c)
    gen = torch.Generator(device=cuda).manual_seed(1)
    cot = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    before = ra.roi_align_pyramid_bwd_cuda.launches
    (got,) = ra.roi_align_pyramid_bwd_cuda(cot, rois, None, [feats.shape],
                                           ONE, out_size, sr, aligned,
                                           flatten)
    assert ra.roi_align_pyramid_bwd_cuda.launches == before + 1
    ref = _plain_grad(feats, rois, cot, out_size, sr, aligned, flatten)
    torch.cuda.synchronize()
    assert got.shape == feats.shape and got.dtype == dtype
    scale = max(1.0, float(ref.float().abs().max()))
    assert float((got.float() - ref.float()).abs().max()) <= tol * scale


@pytest.mark.cuda
def test_roi_align_function_under_autograd(cuda):
    """`batched_roi_align` on a CUDA tensor that needs a gradient goes
    through `RoIAlignPyramidFunction`: one forward and one backward launch,
    the plain version's gradient within 1e-5 of scale, none for the rois;
    under `no_grad` it is the plain forward launch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    feats, rois = _data(cuda, torch.float32)
    f = feats.clone().requires_grad_()
    fwd = ra.roi_align_pyramid_cuda.launches
    bwd = ra.roi_align_pyramid_bwd_cuda.launches
    out = ra.batched_roi_align(f, rois.requires_grad_(), 1 / 16,
                               flatten=True)
    cot = torch.randn_like(out)
    (out * cot).sum().backward()
    assert ra.roi_align_pyramid_cuda.launches == fwd + 1
    assert ra.roi_align_pyramid_bwd_cuda.launches == bwd + 1
    assert rois.grad is None
    ref = _plain_grad(feats, rois.detach(), cot, 7, 2, True, True)
    scale = max(1.0, float(ref.abs().max()))
    assert float((f.grad - ref).abs().max()) <= 1e-5 * scale
    with torch.no_grad():
        ra.batched_roi_align(f, rois, 1 / 16)
    assert ra.roi_align_pyramid_cuda.launches == fwd + 2
    assert ra.roi_align_pyramid_bwd_cuda.launches == bwd + 1


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
    """The kernel pair on four levels: the forward against the plain
    multi-level version, the backward against its autograd (f32 atomics in
    an order that changes from run to run): f32 within 1e-5 of scale, bf16
    within 2e-2; one launch each."""
    feats, rois = _pyramid(cuda, dtype, c=c)
    levels = ra.roi_levels(rois, 4)
    before = ra.roi_align_pyramid_cuda.launches
    got = ra.roi_align_pyramid_cuda(feats, rois, levels, SCALES,
                                    out_size=out_size, flatten=flatten)
    assert ra.roi_align_pyramid_cuda.launches == before + 1
    fs = [f.detach().clone().requires_grad_() for f in feats]
    ref = ra.batched_roi_align_fpn_plain(fs, rois, out_size=out_size,
                                         flatten=flatten)
    _close(got, ref.detach(), tol)

    gen = torch.Generator(device=cuda).manual_seed(1)
    cot = torch.randn(ref.shape, generator=gen, device=cuda).to(dtype)
    before = ra.roi_align_pyramid_bwd_cuda.launches
    grads = ra.roi_align_pyramid_bwd_cuda(cot, rois, levels,
                                          [f.shape for f in feats], SCALES,
                                          out_size=out_size, flatten=flatten)
    assert ra.roi_align_pyramid_bwd_cuda.launches == before + 1
    refs = torch.autograd.grad(ref, fs, cot)
    for g, r in zip(grads, refs):
        _close(g, r, tol)


def _close(got, ref, tol):
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    scale = max(1.0, float(ref.float().abs().max()))
    assert float((got.float() - ref.float()).abs().max()) <= tol * scale


@pytest.mark.cuda
def test_roi_align_fpn_function_under_autograd(cuda):
    """`batched_roi_align_fpn` on CUDA maps that need a gradient: one
    forward and one backward launch, a fifth level ignored (no gradient),
    none for the rois; under `no_grad` only the forward launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    feats, rois = _pyramid(cuda, torch.float32)
    fs = [f.clone().requires_grad_() for f in feats]
    p6 = torch.zeros(2, 3, 4, 40, device=cuda, requires_grad=True)
    fwd = ra.roi_align_pyramid_cuda.launches
    bwd = ra.roi_align_pyramid_bwd_cuda.launches
    out = ra.batched_roi_align_fpn([*fs, p6], rois.requires_grad_(),
                                   flatten=True)
    cot = torch.randn_like(out)
    (out * cot).sum().backward()
    assert ra.roi_align_pyramid_cuda.launches == fwd + 1
    assert ra.roi_align_pyramid_bwd_cuda.launches == bwd + 1
    assert rois.grad is None and p6.grad is None
    plain = [f.detach().clone().requires_grad_() for f in feats]
    refs = torch.autograd.grad(ra.batched_roi_align_fpn_plain(
        plain, rois.detach(), flatten=True), plain, cot)
    for f, r in zip(fs, refs):
        scale = max(1.0, float(r.abs().max()))
        assert float((f.grad - r).abs().max()) <= 1e-5 * scale
    with torch.no_grad():
        ra.batched_roi_align_fpn(fs, rois)
    assert ra.roi_align_pyramid_cuda.launches == fwd + 2
    assert ra.roi_align_pyramid_bwd_cuda.launches == bwd + 1


@pytest.mark.cuda
def test_roi_align_fpn_kernels_refuse_what_they_do_not_take(cuda):
    feats, rois = _pyramid(cuda, torch.float32)
    levels = ra.roi_levels(rois, 4)
    shapes = [f.shape for f in feats]
    g = torch.zeros(2, rois.shape[1], 7, 7, 40, device=cuda)
    fwd, bwd = ra.roi_align_pyramid_cuda, ra.roi_align_pyramid_bwd_cuda
    with pytest.raises(ValueError):               # a CPU tensor
        fwd([feats[0].cpu(), *feats[1:]], rois, levels, SCALES)
    with pytest.raises(ValueError):
        fwd([*feats[:3], feats[3].cpu()], rois, levels, SCALES)
    with pytest.raises(ValueError):
        fwd(feats, rois.cpu(), levels, SCALES)
    with pytest.raises(ValueError):
        bwd(g.cpu(), rois, levels, shapes, SCALES)
    with pytest.raises(TypeError):                # an unsupported dtype
        fwd([f.half() for f in feats], rois, levels, SCALES)
    with pytest.raises(TypeError):
        bwd(g.half(), rois, levels, shapes, SCALES)
    with pytest.raises(ValueError):               # o * sr > 64
        fwd(feats, rois, levels, SCALES, out_size=33)
    with pytest.raises(ValueError):
        bwd(g, rois, levels, shapes, SCALES, out_size=7, sampling_ratio=10)
    with pytest.raises(ValueError):               # levels not int32
        fwd(feats, rois, levels.long(), SCALES)
    with pytest.raises(ValueError):               # several levels, no array
        fwd(feats, rois, None, SCALES)
    with pytest.raises(ValueError):               # not NHWC-contiguous
        fwd([f.transpose(1, 2) for f in feats], rois, levels, SCALES)
    with pytest.raises(ValueError):               # scales and levels
        fwd(feats[:3], rois, levels, SCALES)
    with pytest.raises(ValueError):               # more than four levels
        fwd([*feats, feats[3]], rois, levels, (*SCALES, 1 / 64))


def _both_ways(feats, rois, scale, out_size, sr, aligned=True, flatten=True,
               seed=1):
    """The kernel pair at one level against the plain version and its
    autograd, on the same seeded cotangent. Returns (forward error,
    backward error), each over the reference's scale."""
    f = feats.detach().clone().requires_grad_()
    ref = ra.batched_roi_align_plain(f, rois, scale, out_size, sr, aligned,
                                     flatten)
    got = ra.roi_align_pyramid_cuda([feats], rois, None, (scale,), out_size,
                                    sr, aligned, flatten)
    gen = torch.Generator(device=feats.device).manual_seed(seed)
    cot = torch.randn(ref.shape, generator=gen, device=feats.device).to(
        feats.dtype)
    (ref_g,) = torch.autograd.grad(ref, f, cot)
    (got_g,) = ra.roi_align_pyramid_bwd_cuda(cot, rois, None, [feats.shape],
                                             (scale,), out_size, sr,
                                             aligned, flatten)
    torch.cuda.synchronize()
    errs = []
    for a, b in ((got, ref.detach()), (got_g, ref_g)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.isfinite(a).all()
        scale_ = max(1.0, float(b.float().abs().max()))
        errs.append(float((a.float() - b.float()).abs().max()) / scale_)
    return errs


@pytest.mark.cuda
@pytest.mark.parametrize('out_size,sr', [(14, 4), (32, 2), (64, 1)])
def test_roi_align_kernels_on_a_footprint_beyond_shared_memory(
        cuda, out_size, sr):
    """RoIs over most of a 120x120x64 f32 map: a footprint of up to 122 x
    122 pixels x 256 bytes (3.8 MB), far beyond a block's 227 KB of shared
    memory, at o * sr = 56..64; the kernels stream it a row at a time."""
    rs = np.random.RandomState(2)
    feats = torch.from_numpy(rs.standard_normal((2, 120, 120, 64)).astype(
        np.float32)).to(cuda)
    rois = torch.tensor([[[-8, -8, 1930, 1930], [16, 40, 1900, 1800],
                          [0, 0, 1920, 1920], [500, 3, 1500, 1913]]] * 2,
                        dtype=torch.float32, device=cuda)
    assert max(_both_ways(feats, rois, 1 / 16, out_size, sr)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize('flatten', [False, True])
def test_roi_align_kernels_one_channel_at_o28(cuda, dtype, tol, flatten):
    """The mask slice's targets: C = 1 (the scalar path, one channel a
    block) at o = 28 on scale-1 rasters, boxes inside, across and beyond
    the raster."""
    rs = np.random.RandomState(3)
    feats = torch.from_numpy((rs.uniform(0, 1, (2, 56, 80, 1)) > 0.5).astype(
        np.float32)).to(cuda, dtype)
    rois = torch.from_numpy(edge_case_rois(rs, 2, 24, 56, 80, stride=1)).to(
        cuda)
    errs = _both_ways(feats, rois, 1.0, 28, 2, flatten=flatten)
    assert max(errs) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_roi_align_bwd_kernel_under_contention(cuda, dtype, tol):
    """512 RoIs an image stacked on the same pixels, as a train step's
    positives crowd around a few gt boxes: jittered copies of 4 boxes, from
    under one feature pixel to 12 pixels wide, on a 32x64x256 map. Every
    pixel of a box takes ~128 RoIs' atomics."""
    rs = np.random.RandomState(4)
    feats = torch.from_numpy(rs.standard_normal((2, 32, 64, 256)).astype(
        np.float32)).to(cuda, dtype)
    boxes = np.array([[100, 100, 108, 106], [300, 200, 364, 260],
                      [500, 80, 692, 260], [800, 300, 812, 310]], np.float32)
    rois = boxes[rs.randint(0, 4, (2, 512))] +         rs.uniform(-4, 4, (2, 512, 4)).astype(np.float32)
    errs = _both_ways(feats, torch.from_numpy(rois).to(cuda), 1 / 16, 7, 2)
    assert max(errs) <= tol


# ---- the mask slice's regimes ---------------------------------------------

def _frame_rois(rs, n, m):
    """n RoIs in an m-sized box frame, one per raster, as a train step's
    positives map there (coordinates about [-m, 2m]): inside the raster,
    across its border and far beyond it, some under one pixel, and a zero
    one."""
    lo = rs.uniform(-1.0, 1.2, (n, 2)) * m
    size = np.exp(rs.uniform(np.log(0.2), np.log(1.6 * m), (n, 2)))
    rois = np.concatenate([lo, lo + size], -1)
    rois[:5] = [[0, 0, 0, 0], [0, 0, m, m], [-m, -m, 2 * m, 2 * m],
                [1.1 * m, 1.2 * m, 1.9 * m, 1.95 * m],
                [40.3, 50.1, 40.6, 50.5]]
    return rois[:, None].astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize('out_size', [28, 14])
def test_roi_align_kernels_on_mask_target_rasters(cuda, dtype, tol,
                                                  out_size):
    """The mask targets' regime: 1024 single-RoI 112x112 rasters, C = 1,
    scale 1, the legacy aligned=False geometry (min size 1), RoIs from
    inside the raster to far beyond it and under a pixel."""
    rs = np.random.RandomState(6)
    m = 112
    yy, xx = np.mgrid[:m, :m] + 0.5
    c = rs.uniform(0.3, 0.7, (1024, 2, 1, 1)) * m
    r = rs.uniform(0.2, 0.5, (1024, 2, 1, 1)) * m
    rasters = ((((xx - c[:, 0]) / r[:, 0]) ** 2 +
                ((yy - c[:, 1]) / r[:, 1]) ** 2) <= 1).astype(np.float32)
    feats = torch.from_numpy(rasters[..., None]).to(cuda, dtype)
    rois = torch.from_numpy(_frame_rois(rs, 1024, m)).to(cuda)
    errs = _both_ways(feats, rois, 1.0, out_size, 2, aligned=False,
                      flatten=False)
    assert max(errs) <= tol


@pytest.mark.cuda
def test_mask_targets_launch_one_forward_and_match_the_cpu(cuda):
    """`mask_targets_from_box_frame` on the card: one forward launch, no
    backward, and the CPU's plain targets within 1e-5."""
    from unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.models.roi_heads import \
        mask_head
    rs = np.random.RandomState(7)
    masks = (rs.uniform(0, 1, (2, 4, 112, 112)) > 0.5).astype(np.uint8)
    xy = rs.uniform(0, 300, (2, 4, 2))
    gt = np.concatenate([xy, xy + rs.uniform(4, 200, (2, 4, 2))], -1)
    rois = np.concatenate([xy[:, [0, 1, 2, 3] * 8] - 30,
                           xy[:, [0, 1, 2, 3] * 8] + 150], -1)
    rois += rs.uniform(-20, 20, rois.shape)
    matched = np.tile(np.arange(4), 8)[None].repeat(2, 0)
    args = [torch.from_numpy(a) for a in (
        masks, gt.astype(np.float32), rois.astype(np.float32),
        matched.astype(np.int64))]
    fwd = ra.roi_align_pyramid_cuda.launches
    bwd = ra.roi_align_pyramid_bwd_cuda.launches
    got = mask_head.mask_targets_from_box_frame(*[a.to(cuda) for a in args])
    assert ra.roi_align_pyramid_cuda.launches == fwd + 1
    assert ra.roi_align_pyramid_bwd_cuda.launches == bwd
    ref = mask_head.mask_targets_from_box_frame(*args)
    assert got.shape == ref.shape == (2, 32, 28, 28)
    assert float((got.cpu() - ref).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_roi_align_kernels_on_mask_features(cuda, dtype, tol):
    """The FPN mask features' regime: 14x14, (B, R, o, o, C) with C = 256,
    four levels, forward and backward."""
    feats, rois = _pyramid(cuda, dtype, c=256)
    levels = ra.roi_levels(rois, 4)
    got = ra.roi_align_pyramid_cuda(feats, rois, levels, SCALES, 14)
    fs = [f.detach().clone().requires_grad_() for f in feats]
    ref = ra.batched_roi_align_fpn_plain(fs, rois, out_size=14)
    _close(got, ref.detach(), tol)
    gen = torch.Generator(device=cuda).manual_seed(2)
    cot = torch.randn(ref.shape, generator=gen, device=cuda).to(dtype)
    grads = ra.roi_align_pyramid_bwd_cuda(cot, rois, levels,
                                          [f.shape for f in feats], SCALES,
                                          14)
    for g, r in zip(grads, torch.autograd.grad(ref, fs, cot)):
        _close(g, r, tol)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_roi_align_kernels_on_c4_crops(cuda, dtype, tol):
    """C4's regime: one level at stride 16, 14x14 crops (B, R, o, o, C) of
    C = 1024, forward and backward."""
    feats, rois = _data(cuda, dtype, h=12, w=20, c=1024, n=40)
    errs = _both_ways(feats, rois, 1 / 16, 14, 2, flatten=False)
    assert max(errs) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize('aligned', [True, False])
def test_roi_align_kernels_on_zero_area_rois(cuda, dtype, tol, aligned):
    """Zero-area RoIs, as `predict` hands the mask branch its padded
    detections: every sample of a bin falls on one point (aligned), or the
    min-size-1 box (legacy); at one level and on four (they fall on P2)."""
    feats, rois = _data(cuda, dtype, c=40)
    pts = rois[..., :2].clone()
    rois = torch.cat([pts, pts], -1)
    rois[:, :4] = 0
    errs = _both_ways(feats, rois, 1 / 16, 14, 2, aligned=aligned,
                      flatten=False)
    assert max(errs) <= tol
    pyr, _ = _pyramid(cuda, dtype, c=40)
    levels = ra.roi_levels(rois, 4)
    assert int(levels.max()) == 0
    got = ra.roi_align_pyramid_cuda(pyr, rois, levels, SCALES, 14,
                                    aligned=aligned)
    _close(got, ra.batched_roi_align_fpn_plain(pyr, rois, out_size=14,
                                               aligned=aligned), tol)


SYNTH = pathlib.Path(__file__).resolve().parent / 'data' / 'synth_da_small'
SYNTH_TRAIN = dict(
    type='ConcatDataset', datasets=[
        dict(type='DADataset', classes=('square', 'circle'), domain=domain,
             ann_file=f'{SYNTH}/{sub}/ImageSets/Main/train.txt',
             img_prefix=f'{SYNTH}/{sub}/',
             pipeline=[dict(type='LoadImageFromFile'),
                       dict(type='LoadAnnotations', with_bbox=True),
                       dict(type='Resize', img_scale=(192, 128)),
                       dict(type='RandomFlip', flip_ratio=0.5),
                       dict(type='Normalize'),
                       dict(type='Pad', size=(128, 192)),
                       dict(type='PackDetInputs', max_gt=10)])
        for sub, domain in (('shapes_clear', 'source'),
                            ('shapes_foggy', 'target'))])


@pytest.mark.cuda
def test_loader_batches_on_the_card_equal_the_cpu_ones(cuda):
    """Two epochs of the synth subset's two-stream loader made on the card
    equal those made on the CPU, image included: decode on the host, then
    the same elementwise float32 ops in the same order on both."""
    from unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.data import (
        DataLoader, build_dataset)
    loaders = [DataLoader(build_dataset(SYNTH_TRAIN, d), 8, seed=0)
               for d in ('cuda', 'cpu')]
    n = 0
    for _ in range(2):
        for got, ref in zip(*loaders):
            assert set(got) == set(ref)
            for k, v in ref.items():
                assert got[k].device.type == 'cuda'
                assert torch.equal(got[k].cpu(), v), k
            n += 1
    assert n == 8


@pytest.mark.cuda
def test_inference_on_a_jpeg_path_equals_the_decoded_array(cuda):
    """`inference_detector` on JPEG paths (decoded by the port's decoder,
    the rest on the card) equals it on the same images passed as arrays."""
    from unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.apis import (
        inference_detector, init_detector)
    from unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.data.pipelines.jpeg import \
        decode_jpeg
    root = SYNTH.parent.parent.parent
    paths = [str(p) for p in sorted(
        (root / 'tests/data/voc_source/JPEGImages').glob('*.jpg'))]
    bundle = init_detector(
        str(root / 'configs/da/faster_rcnn_r18_tiny_fixture.py'),
        device=cuda, seed=3)
    from_paths = inference_detector(bundle, paths)
    from_arrays = inference_detector(bundle, [decode_jpeg(p) for p in paths])
    assert sum(len(d) for r in from_paths for d in r) > 0
    for a, b in zip(from_paths, from_arrays):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
