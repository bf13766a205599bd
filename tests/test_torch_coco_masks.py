"""The port's mask annotations against the JAX package's: the polygon fill
(`data/pipelines/polygon.py`) against Pillow's, which the JAX package draws
with, bit for bit on the polygons the datasets carry and on random ones;
`LoadAnnotations(with_mask=True)` on every instance of the committed
synth split and on edge cases; the mask flip, `RandomCrop`, `AutoAugment`
and `PackDetInputs(with_mask=True)` with their random draws, and the
options that raise. Everything is exact."""

import importlib
import json
import math
import pathlib

import numpy as np
import pytest
import torch

from .torch_port_utils import JAX_PKG, PORT_PKG, native_library

Image = pytest.importorskip('PIL.Image')
ImageDraw = pytest.importorskip('PIL.ImageDraw')

ROOT = pathlib.Path(__file__).resolve().parent.parent
SEG = ROOT / 'tests/data/synth_seg'

jtf = importlib.import_module(f'{JAX_PKG}.data.pipelines.transforms')
jaa = importlib.import_module(f'{JAX_PKG}.data.pipelines.auto_augment')
ttf = importlib.import_module(f'{PORT_PKG}.data.pipelines.transforms')
taa = importlib.import_module(f'{PORT_PKG}.data.pipelines.auto_augment')
tpoly = importlib.import_module(f'{PORT_PKG}.data.pipelines.polygon')


def _pil_fill(points, size):
    img = Image.new('L', (size, size), 0)
    ImageDraw.Draw(img).polygon([tuple(p) for p in points], fill=1)
    return np.asarray(img)


def _port_fill(points, size):
    return tpoly.fill_polygon(np.zeros((size, size), np.uint8),
                              np.asarray(points, np.float64))


def _polygon(rs, kind, size):
    """float32 vertices of one polygon of `kind` in a size² frame."""
    if kind == 'convex':
        n = rs.randint(3, 24)
        c, r = rs.uniform(0, size, 2), rs.uniform(1, size)
        t = np.sort(rs.uniform(0, 2 * np.pi, n))
        pts = np.stack([c[0] + r * np.cos(t), c[1] + r * np.sin(t)], 1)
    elif kind == 'concave':      # star-shaped: radii drawn per vertex
        n = rs.randint(5, 40)
        c = rs.uniform(0.2 * size, 0.8 * size, 2)
        t = np.sort(rs.uniform(0, 2 * np.pi, n))
        r = rs.uniform(0.05 * size, 0.7 * size, n)
        pts = np.stack([c[0] + r * np.cos(t), c[1] + r * np.sin(t)], 1)
    elif kind == 'past_the_box':
        n = rs.randint(3, 16)
        pts = rs.uniform(-0.5 * size, 1.5 * size, (n, 2))
        pts = pts[np.argsort(np.arctan2(pts[:, 1] - size / 2,
                                        pts[:, 0] - size / 2))]
    else:                        # 'tiny': a few pixels wide
        n = rs.randint(3, 8)
        pts = rs.uniform(0, 6, (n, 2)) + rs.uniform(0, size - 6, 2)
    return pts.astype(np.float32)


@pytest.mark.parametrize('size', [56, 112])
@pytest.mark.parametrize('kind', ['convex', 'concave', 'past_the_box',
                                  'tiny'])
def test_polygon_fill_equals_pillow(kind, size):
    rs = np.random.RandomState(size + len(kind))
    for _ in range(150):
        pts = _polygon(rs, kind, size)
        assert np.array_equal(_port_fill(pts, size), _pil_fill(pts, size)), \
            pts.tolist()


# outlines that return to an earlier vertex (after the cast to int), so
# that three or more edges meet there: where the port's corner rule still
# differs from Pillow's, it is in these pixels (ROADMAP.md, Queue 3)
REVISITING = [
    ([(7, 2), (-2, 0), (6, -1), (7, 2), (2, 0), (7, 1)], 0),
    ([(5, 1), (1, 6), (2, 9), (8, 0), (3, 1), (5, 1), (8, 2)], 1),
    ([(0, 4), (8, 5), (5, 2), (0, 4), (5, 5), (7, 0), (4, 0), (0, 0),
      (0, 9)], 0)]


@pytest.mark.parametrize('case', range(len(REVISITING)))
def test_polygon_fill_where_the_outline_revisits_a_vertex(case):
    """The known residue, pinned: the count of pixels that differ from
    Pillow on each such outline, all of them on the revisited vertex's
    rows."""
    pts, n_diff = REVISITING[case]
    diff = _port_fill(np.float32(pts), 8) != _pil_fill(np.float32(pts), 8)
    assert int(diff.sum()) == n_diff
    revisited = {y for x, y in pts if pts.count((x, y)) > 1}
    assert set(np.nonzero(diff)[0].tolist()) <= revisited


def _fuzz_residue(seed, count, lo, hi, n, every, max_vertices):
    """(outlines, pixels) where the fill differs from Pillow's among `count`
    seeded integer outlines of 3 to `max_vertices` vertices with
    coordinates in [lo, hi]
    on an n x n raster, every `every`-th of them with 1-2 earlier vertices
    visited again; each differing pixel must lie on a revisited vertex's
    row."""
    rs = np.random.RandomState(seed)
    outlines, pixels = 0, 0
    for t in range(count):
        pts = [tuple(int(v) for v in rs.randint(lo, hi + 1, 2))
               for _ in range(rs.randint(3, max_vertices + 1))]
        if t % every == 0:
            for _ in range(rs.randint(1, 3)):
                pts.insert(rs.randint(0, len(pts) + 1),
                           pts[rs.randint(0, len(pts))])
        diff = _port_fill(np.float32(pts), n) != _pil_fill(np.float32(pts), n)
        if diff.any():
            outlines += 1
            pixels += int(diff.sum())
            revisited = {y for x, y in pts if pts.count((x, y)) > 1}
            assert set(np.nonzero(diff)[0].tolist()) <= revisited, pts
    return outlines, pixels


def test_polygon_fill_on_fuzzed_revisiting_outlines():
    """300 seeded integer outlines of 3-7 vertices on a 12x12 raster, each
    with 1-2 earlier vertices visited again: the fill equals Pillow's on
    all but 3 of them, which differ in 7 pixels in all, each on a
    revisited vertex's row (the open fault of `ROADMAP.md` Queue 3,
    pinned)."""
    assert _fuzz_residue(0, 300, 0, 12, 12, every=1, max_vertices=7) == (3, 7)


def test_polygon_fill_on_fuzzed_outlines_past_the_raster():
    """1000 seeded integer outlines of 3-8 vertices with coordinates from
    -1 to n + 1 on a 12x12 raster, every second one revisiting 1-2
    earlier vertices: the fill equals Pillow's on all but 7 of them, 14
    pixels in all, each on a revisited vertex's row (pinned with the open
    fault of `ROADMAP.md` Queue 3)."""
    assert _fuzz_residue(1, 1000, -1, 13, 12, every=2,
                         max_vertices=8) == (7, 14)


def _synth_polygon(rs, circle):
    """A polygon as `make_synthetic_da_dataset.py --coco-masks` writes it
    (square 4-gon or circle 16-gon of an s-pixel box) and its box."""
    s = rs.randint(14, 36)
    x1, y1 = rs.randint(0, 156), rs.randint(0, 92)
    if not circle:
        poly = [x1, y1, x1 + s, y1, x1 + s, y1 + s, x1, y1 + s]
    else:
        cx, cy, r = (2 * x1 + s) / 2, (2 * y1 + s) / 2, s / 2
        poly = []
        for k in range(16):
            a = 2 * math.pi * k / 16
            poly += [cx + r * math.cos(a), cy + r * math.sin(a)]
    return poly, [x1, y1, x1 + s, y1 + s]


def _both(ann, mask_size, boxes=None):
    """JAX and port `LoadAnnotations(with_mask=True)` on one annotation,
    with the boxes replaced by `boxes` (as a Resize or crop would leave
    them) when given."""
    outs = []
    for mod in (jtf, ttf):
        res = dict(ann_info=ann)
        load = mod.LoadAnnotations(with_mask=True, mask_size=mask_size)
        if boxes is not None:
            load.with_mask = False
            res = load(res)
            res['gt_bboxes'] = np.asarray(boxes, np.float32)
            load.with_mask = True
            load.with_bbox = load.with_label = False
        outs.append(load(res)['gt_masks'])
    return outs


def _ann(polys, boxes):
    return dict(bboxes=np.asarray(boxes, np.float32).reshape(-1, 4),
                labels=np.zeros(len(boxes), np.int64), masks=polys)


@pytest.mark.parametrize('mask_size', [56, 112])
def test_load_annotations_rasters_equal_jax(mask_size):
    """Synth 4-gons and 16-gons in their boxes and in resized boxes; several
    parts an instance; parts of under 3 points (skipped) and instances
    without polygons (zero rasters); polygons past their box; boxes
    narrower than the 1e-3 floor."""
    rs = np.random.RandomState(mask_size)
    polys, boxes = [], []
    for i in range(60):
        poly, box = _synth_polygon(rs, circle=i % 2 == 1)
        polys.append([poly])
        boxes.append(box)
    got, ref = _both(_ann(polys, boxes), mask_size)
    assert got.shape == (60, mask_size, mask_size) and got.any()
    assert np.array_equal(got, ref)
    scaled = np.asarray(boxes, np.float32) * np.float32(800 / 128)
    got, ref = _both(_ann(polys, boxes), mask_size, boxes=scaled)
    assert np.array_equal(got, ref)

    parts = [[polys[0][0], polys[1][0], [1.0, 2.0, 3.0, 4.0]],   # 3 parts
             [[5.0, 5.0, 9.0, 9.0]],                              # < 3 points
             [],                                                  # none
             [_polygon(rs, 'concave', 40).ravel().tolist()],
             [(_polygon(rs, 'past_the_box', 20) + 30).ravel().tolist()],
             polys[2], polys[3]]
    narrow = [[0, 0, 192, 128], [3, 3, 12, 12], [0, 0, 9, 9],
              [0, 0, 40, 40], [36, 36, 44, 44],
              [10.0, 20.0, 10.0, 50.0],               # zero width
              [10.0, 20.0, 10.0005, 20.0002]]          # under 1e-3
    got, ref = _both(_ann(parts, narrow), mask_size)
    assert not got[1].any() and not got[2].any() and got[0].any()
    assert np.array_equal(got, ref)


def test_load_annotations_on_every_committed_instance():
    for split in ('train', 'test'):
        with open(SEG / f'{split}.json') as f:
            coco = json.load(f)
        polys = [a['segmentation'] for a in coco['annotations']]
        boxes = [[x, y, x + w, y + h]
                 for x, y, w, h in (a['bbox'] for a in coco['annotations'])]
        for m in (56, 112):
            got, ref = _both(_ann(polys, boxes), m)
            assert np.array_equal(got, ref), (split, m)


def test_mask_flip_and_pack_equal_jax():
    rs = np.random.RandomState(0)
    t_rng, j_rng = np.random.RandomState(4), np.random.RandomState(4)
    flips = []
    for i in range(10):
        img = rs.randint(0, 256, (20, 30, 3)).astype(np.uint8)
        n = i % 4
        boxes = rs.uniform(0, 20, (n, 4)).astype(np.float32)
        boxes[:, 2:] += boxes[:, :2]
        masks = rs.randint(0, 2, (n, 56, 56)).astype(np.uint8)
        base = dict(img_shape=(20, 30), ori_shape=(20, 30), gt_bboxes=boxes,
                    gt_labels=np.arange(n), gt_masks=masks)
        j = jtf.RandomFlip(0.5)(dict(base, img=img, _rng=j_rng))
        t = ttf.RandomFlip(0.5)(dict(base, img=torch.from_numpy(img),
                                     _rng=t_rng))
        assert t['flip'] == j['flip']
        assert np.array_equal(t['gt_masks'], j['gt_masks'])
        flips.append(t['flip'])
        jp = jtf.PackDetInputs(max_gt=5, with_mask=True)(j)
        tp = ttf.PackDetInputs(max_gt=5, with_mask=True)(t)
        assert set(tp) == set(jp)
        for k in jp:
            got = tp[k].numpy() if isinstance(tp[k], torch.Tensor) else tp[k]
            assert np.array_equal(got, jp[k]), k
        # an image without instances packs 112² rasters, as in JAX
        assert tp['gt_masks'].shape == (5, 56 if n else 112,
                                         56 if n else 112)
    assert 0 < sum(flips) < len(flips)


def _crop_inputs(rs, n, h=60, w=90):
    img = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
    xy = rs.uniform(0, [w - 5, h - 5], (n, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(2, 30, (n, 2))],
                           1).astype(np.float32)
    return img, dict(img_shape=(h, w), gt_bboxes=boxes,
                     gt_labels=np.arange(n),
                     gt_masks=rs.randint(0, 2, (n, 8, 8)).astype(np.uint8))


@pytest.mark.parametrize('crop', [
    dict(crop_size=(30, 40)),
    dict(crop_size=(20, 70), crop_type='absolute_range'),
    dict(crop_size=(10, 14), crop_type='absolute_range',
         allow_negative_crop=True),
    dict(crop_size=(100, 200))])               # larger than the image
def test_random_crop_equals_jax(crop):
    rs = np.random.RandomState(len(str(crop)))
    t_rng, j_rng = np.random.RandomState(9), np.random.RandomState(9)
    outcomes = set()
    for i in range(40):
        img, base = _crop_inputs(rs, n=1 + i % 3)
        j = jtf.RandomCrop(**crop)(dict(base, img=img, _rng=j_rng))
        t = ttf.RandomCrop(**crop)(dict(base, img=torch.from_numpy(img),
                                        _rng=t_rng))
        assert np.array_equal(t['img'].numpy(), j['img'])
        assert tuple(t['img_shape']) == tuple(j['img_shape'])
        for k in ('gt_bboxes', 'gt_labels', 'gt_masks'):
            assert np.array_equal(t[k], j[k]), k
        outcomes.add((len(t['gt_labels']) < len(base['gt_labels']),
                      len(t['gt_labels']) == 0,
                      t['img'].shape[:2] == img.shape[:2]))
    if crop['crop_size'][0] < 60:
        assert (True, False, False) in outcomes    # some boxes dropped
    # with `allow_negative_crop` an image may keep no box; without, never
    assert any(o[1] for o in outcomes) == bool(crop.get(
        'allow_negative_crop'))


def test_random_crop_is_a_view_of_the_image():
    rs = np.random.RandomState(2)
    img, base = _crop_inputs(rs, 2)
    src = torch.from_numpy(img)
    out = ttf.RandomCrop((30, 40))(dict(base, img=src,
                                        _rng=np.random.RandomState(0)))
    assert out['img'].data_ptr() != 0 and \
        out['img'].untyped_storage().data_ptr() == \
        src.untyped_storage().data_ptr()


def test_auto_augment_picks_policies_as_jax():
    """The Swin ms-crop-3x recipe, cut to a small canvas: each image takes
    one of two sub-policies (a multi-scale Resize; a Resize, a range crop
    that may leave no box, and a Resize), drawn from the dataset's
    generator in the JAX order."""
    native_library()   # the JAX uint8 resize must be the native one
    policies = [
        [dict(type='Resize', img_scale=[(40, 100), (48, 100), (56, 100)],
              multiscale_mode='value', keep_ratio=True)],
        [dict(type='Resize', img_scale=[(30, 100), (36, 100)],
              multiscale_mode='value', keep_ratio=True),
         dict(type='RandomCrop', crop_type='absolute_range',
              crop_size=(12, 24), allow_negative_crop=True),
         dict(type='Resize', img_scale=[(40, 100), (56, 100)],
              multiscale_mode='value', keep_ratio=True)]]
    j_aa, t_aa = jaa.AutoAugment(policies), taa.AutoAugment(policies)
    rs = np.random.RandomState(5)
    t_rng, j_rng = np.random.RandomState(11), np.random.RandomState(11)
    shapes = set()
    for i in range(30):
        img, base = _crop_inputs(rs, n=1 + i % 3, h=32, w=48)
        j = j_aa(dict(base, img=img, _rng=j_rng))
        t = t_aa(dict(base, img=torch.from_numpy(img), _rng=t_rng))
        assert tuple(t['img_shape']) == tuple(j['img_shape'])
        # the resizes agree within one grey level (test_torch_pipeline.py)
        diff = np.abs(t['img'].numpy().astype(int) - j['img'].astype(int))
        assert diff.max() <= 1
        for k in ('gt_bboxes', 'gt_labels', 'gt_masks', 'scale_factor'):
            assert np.array_equal(t[k], j[k]), k
        shapes.add(tuple(j['img_shape']))
    assert len(shapes) > 3
    assert int(t_rng.randint(1 << 30)) == int(j_rng.randint(1 << 30))


@pytest.mark.parametrize('op', ['Shear', 'Rotate', 'Translate',
                                'ColorTransform', 'BrightnessTransform',
                                'ContrastTransform', 'EqualizeTransform'])
def test_auto_augment_image_ops_raise(op):
    with pytest.raises(NotImplementedError, match=op):
        taa.AutoAugment([[dict(type=op, level=4, prob=0.5)]])


@pytest.mark.parametrize('kw', [dict(with_full_masks=True),
                                dict(with_semantic=True)])
def test_full_masks_and_semantic_maps_raise(kw):
    with pytest.raises(NotImplementedError, match='SOLO and panoptic'):
        ttf.PackDetInputs(with_mask=True, **kw)
