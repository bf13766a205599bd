"""Port's test-time pipeline (antialiased resize, normalize, pad, pack,
collate) vs the JAX package's. The JAX resize is its native C++ one where a
compiler is present, else cv2/PIL; the port copies the PIL-convention
algorithm of the native one, so it may differ from the JAX result by at most
one grey level (in practice it matches it exactly)."""

import importlib

import numpy as np
import pytest
import torch

from .torch_port_utils import JAX_PKG, PORT_PKG, native_library

jtf = importlib.import_module(f'{JAX_PKG}.data.pipelines.transforms')
jbuilder = importlib.import_module(f'{JAX_PKG}.data.builder')
ttf = importlib.import_module(f'{PORT_PKG}.data.pipelines.transforms')
tdata = importlib.import_module(f'{PORT_PKG}.data')


@pytest.mark.parametrize('src_hw,dst_wh', [((123, 217), (100, 57)),
                                           ((64, 96), (96, 64)),
                                           ((50, 70), (131, 93)),
                                           ((300, 200), (41, 61))])
def test_imresize_within_one_grey_level(src_hw, dst_wh):
    native_library()   # the JAX uint8 resize must be the native one
    img = np.random.RandomState(sum(src_hw)).randint(
        0, 256, src_hw + (3,)).astype(np.uint8)
    ref = jtf._imresize(img, dst_wh)
    got = ttf.imresize(torch.from_numpy(img), dst_wh).numpy()
    assert got.shape == ref.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize('src_hw,dst_wh', [((1024, 2048), (1000, 500)),
                                           ((1024, 2048), (1000, 600)),
                                           ((123, 217), (100, 57)),
                                           ((50, 70), (131, 93)),
                                           ((64, 96), (96, 64))])
def test_imresize_of_a_float_image_follows_cv2(src_hw, dst_wh):
    """A float image (as `PhotoMetricDistortion` leaves it) resizes as the
    JAX `_imresize` resizes it, through cv2's `INTER_LINEAR`: within 2e-4
    of the 255 range (0.051; the largest gap, at the DeepAlign-Swin
    pipeline's 2048x1024 → (1000, 500), is ~0.038: the two compute the
    taps' weights in another precision), on downscales, upscales and
    non-integer factors; the antialiased filter that the uint8 path uses
    is off by grey levels there."""
    rs = np.random.RandomState(sum(src_hw) + dst_wh[0])
    img = (rs.uniform(-20, 275, src_hw + (3,))).astype(np.float32)
    ref = jtf._imresize(img, dst_wh)
    got = ttf.imresize(torch.from_numpy(img), dst_wh).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.abs(got - ref).max() <= 2e-4 * 255


def test_test_pipeline_and_collate_match():
    native_library()   # the JAX uint8 resize must be the native one
    rs = np.random.RandomState(0)
    imgs = [rs.randint(0, 256, hw + (3,)).astype(np.uint8)
            for hw in ((90, 160), (130, 95))]
    steps = lambda m: [m.Resize(img_scale=(96, 64)), m.Normalize(),  # noqa
                       m.Pad(size=(96, 96)), m.PackDetInputs(max_gt=3)]
    jpipe, tpipe = jtf.Compose(steps(jtf)), ttf.Compose(steps(ttf))
    jsamples, tsamples = [], []
    for img in imgs:
        gt = dict(gt_bboxes=np.array([[5, 6, 40, 50]], np.float32),
                  gt_labels=np.array([1]))
        meta = dict(img_shape=img.shape[:2], ori_shape=img.shape[:2], **gt)
        jsamples.append(jpipe(dict(img=img, **meta)))
        tsamples.append(tpipe(dict(img=torch.from_numpy(img),
                                   **{k: v.copy() if hasattr(v, 'copy')
                                      else v for k, v in meta.items()})))
    ref = jbuilder.collate(jsamples)
    got = tdata.collate(tsamples)
    assert set(got) == set(ref)
    for k, r in ref.items():
        g = got[k].numpy()
        assert g.shape == r.shape, k
        if k == 'image':     # one grey level / std
            np.testing.assert_allclose(g, r, atol=1.0 / 57.0 + 1e-6)
        else:
            np.testing.assert_array_equal(g, r.astype(g.dtype))


def test_pad_refuses_an_image_larger_than_the_canvas():
    with pytest.raises(ValueError, match='exceeds the fixed canvas'):
        ttf.Pad(size=(8, 8))(dict(img=torch.zeros(9, 8, 3)))
