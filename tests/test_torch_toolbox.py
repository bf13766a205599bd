"""PyTorch port vs JAX package: config loading, boxes, IoU, anchors, NMS,
and the port's import and device rules. Everything here runs on the CPU."""

import ast
import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unsupervised_domain_adaptation_object_detection_implementation_tpu.core.anchors.anchor_generator import \
    AnchorGenerator as JAnchorGenerator
from unsupervised_domain_adaptation_object_detection_implementation_tpu.utils.config import \
    Config as JConfig
from unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.core.anchors.anchor_generator import \
    AnchorGenerator
from unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.utils.config import \
    Config

from .torch_port_utils import JAX_PKG, PORT_PKG

jiou = importlib.import_module(f'{JAX_PKG}.core.bbox.iou')
jtf = importlib.import_module(f'{JAX_PKG}.core.bbox.transforms')
jnms = importlib.import_module(f'{JAX_PKG}.core.post.nms')
tiou = importlib.import_module(f'{PORT_PKG}.core.bbox.iou')
ttf = importlib.import_module(f'{PORT_PKG}.core.bbox.transforms')
tnms = importlib.import_module(f'{PORT_PKG}.core.post.nms')

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _boxes(rs, shape, size=100.0):
    xy = rs.uniform(0, size, shape + (2,))
    wh = rs.uniform(1.0, size / 2, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize('cfg', ['configs/da/faster_rcnn_r50_daf_c2f.py',
                                 'configs/da/faster_rcnn_r18_tiny_fixture.py'])
def test_config_loads_like_jax(cfg):
    ours = Config.fromfile(str(ROOT / cfg)).to_dict()
    theirs = JConfig.fromfile(str(ROOT / cfg)).to_dict()
    assert ours == theirs


@pytest.mark.parametrize('mode,offset', [('iou', 0.0), ('iof', 0.0),
                                         ('iou', 1.0)])
def test_bbox_overlaps(mode, offset):
    rs = np.random.RandomState(0)
    a, b = _boxes(rs, (3, 17)), _boxes(rs, (3, 23))
    ref = np.asarray(jiou.bbox_overlaps(a, b, mode=mode, offset=offset))
    got = tiou.bbox_overlaps(torch.from_numpy(a), torch.from_numpy(b),
                             mode=mode, offset=offset).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_delta_coding_and_clip():
    rs = np.random.RandomState(1)
    rois = _boxes(rs, (2, 50))
    deltas = rs.normal(0, 2.0, (2, 50, 4)).astype(np.float32)
    deltas[:, :5, 2:] = 30.0                 # beyond the wh_ratio_clip clamp
    deltas[:, 5:10, 2:] = -30.0
    shape = np.array([[60, 80], [90, 70]], np.float32)
    stds = (0.1, 0.1, 0.2, 0.2)
    ref = np.asarray(jtf.delta2bbox(rois, deltas, stds=stds,
                                    max_shape=shape[:, None, :]))
    got = ttf.delta2bbox(torch.from_numpy(rois), torch.from_numpy(deltas),
                         stds=stds, max_shape=torch.from_numpy(shape)[:, None])
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)
    gt = _boxes(rs, (2, 50))
    ref = np.asarray(jtf.bbox2delta(rois, gt, stds=stds))
    got = ttf.bbox2delta(torch.from_numpy(rois), torch.from_numpy(gt),
                         stds=stds).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_bbox2result():
    rs = np.random.RandomState(2)
    boxes = _boxes(rs, (12,))
    labels = rs.randint(0, 3, 12)
    scores = rs.rand(12).astype(np.float32)
    valid = rs.rand(12) > 0.3
    ref = jtf.bbox2result(boxes, labels, scores, valid, 3)
    got = ttf.bbox2result(boxes, labels, scores, valid, 3)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize('strides,scales,size', [
    ([16], [2, 4, 8, 16, 32], (38, 64)),
    ([16], [1, 2], (4, 6)),
    ([4, 8], [8], (7, 5))])
def test_anchor_generator(strides, scales, size):
    kw = dict(strides=strides, ratios=[0.5, 1.0, 2.0], scales=scales)
    sizes = [size] * len(strides)
    for r, g in zip(JAnchorGenerator(**kw).grid_priors(sizes),
                    AnchorGenerator(**kw).grid_priors(sizes)):
        np.testing.assert_array_equal(g, r)


def _nms_inputs(seed, n, tie_every=0, invalid_frac=0.2):
    rs = np.random.RandomState(seed)
    boxes = _boxes(rs, (n,), size=200.0)
    scores = rs.rand(n).astype(np.float32)
    if tie_every:
        scores[::tie_every] = 0.5          # many exact ties
    scores[rs.rand(n) < invalid_frac] = jnms.NEG_INF
    return boxes, scores


@pytest.mark.parametrize('n,tile,thr,tie_every', [
    (100, 256, 0.5, 0),
    (700, 256, 0.7, 0),     # more than one tile
    (700, 256, 0.3, 3),     # ties across tiles
    (513, 512, 0.7, 2)])
def test_nms_keep_set_matches(n, tile, thr, tie_every):
    boxes, scores = _nms_inputs(n, n, tie_every)
    keep_ref, order_ref = jax.jit(jnms.nms, static_argnums=(2, 3))(
        boxes, scores, thr, tile)
    keep, order = tnms.nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                           thr, tile)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(keep_ref))
    np.testing.assert_array_equal(order.numpy(), np.asarray(order_ref))


def test_nms_batched_rows_and_all_invalid():
    rows = [_nms_inputs(s, 300, tie_every=4) for s in range(3)]
    boxes = np.stack([r[0] for r in rows])
    scores = np.stack([r[1] for r in rows])
    scores[1] = jnms.NEG_INF                 # an all-invalid row
    keep, _ = tnms.nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                       0.6, 128)
    for i in range(3):
        ref, _ = jnms.nms(boxes[i], scores[i], 0.6, 128)
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(ref))
    assert not keep[1].any()


def test_batched_nms_offsets_classes():
    boxes, scores = _nms_inputs(5, 400, tie_every=5)
    boxes = boxes - 50.0                     # negative coordinates too
    idxs = np.random.RandomState(6).randint(0, 4, 400)
    ref, _ = jnms.batched_nms(boxes, scores, idxs, 0.5, 256)
    got, _ = tnms.batched_nms(torch.from_numpy(boxes),
                              torch.from_numpy(scores),
                              torch.from_numpy(idxs), 0.5, 256)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize('shared,pre,max_det', [(False, 0, 100),
                                                (False, 200, 30),
                                                (True, 0, 500)])
def test_multiclass_nms(shared, pre, max_det):
    rs = np.random.RandomState(7)
    n, c = 120, 3
    boxes = _boxes(rs, (n,) if shared else (n, c), size=150.0)
    boxes = boxes.reshape(n, -1)
    scores = rs.rand(n, c + 1).astype(np.float32)
    scores[::7, 1] = 0.75                    # ties
    ref = jnms.multiclass_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.05,
                              0.5, max_det, 256, pre)
    got = tnms.multiclass_nms(torch.from_numpy(boxes)[None],
                              torch.from_numpy(scores)[None], 0.05, 0.5,
                              max_det, 256, pre)
    np.testing.assert_array_equal(got[2][0].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(got[1][0].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[0][0].numpy(), np.asarray(ref[0]),
                               rtol=0, atol=0)


def _imported_modules(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                yield node.module
            else:               # relative imports stay inside the port
                yield PORT_PKG


def test_port_and_chip_smoke_import_no_jax():
    """Nothing of JAX or the JAX package, and no image library (the card
    machine has neither PIL nor cv2: the port decodes JPEGs itself)."""
    files = sorted((ROOT / PORT_PKG).rglob('*.py')) + [ROOT / 'chip_smoke.py']
    assert len(files) > 20
    banned = ('jax', 'jaxlib', 'flax', 'optax', JAX_PKG, 'PIL', 'cv2')
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split('.')[0]
            assert top not in banned, f'{f} imports {mod}'


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    from unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.apis import \
        init_detector
    from unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.models import \
        build_detector
    cfg = str(ROOT / 'configs/da/faster_rcnn_r18_tiny_fixture.py')
    with pytest.raises(RuntimeError, match='cuda'):
        init_detector(cfg)
    with pytest.raises(RuntimeError, match='cuda'):
        build_detector(Config.fromfile(cfg).model)
    with pytest.raises(RuntimeError, match='cuda'):
        init_detector(cfg, device='cuda:0')
