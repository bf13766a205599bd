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
    feats, rois = _data(cuda, torch.float32)
    with pytest.raises(NotImplementedError, match='training slice'):
        ra.batched_roi_align(feats.requires_grad_(), rois, 1 / 16)
    feats = feats.detach()
    with pytest.raises(TypeError):
        ra.batched_roi_align(feats.half(), rois, 1 / 16)
    with pytest.raises(ValueError):
        ra.batched_roi_align(feats.transpose(1, 2), rois, 1 / 16)
    with pytest.raises(ValueError):
        ra.batched_roi_align(feats, rois.cpu(), 1 / 16)
    with pytest.raises(ValueError):
        ra.batched_roi_align(feats, rois, 1 / 16, out_size=33,
                             sampling_ratio=2)
