"""The port's VOC evaluation against the JAX package's: `average_precision`,
`tpfp_default`, `eval_map` and `eval_recalls` on seeded random detections
(with ignored and difficult gts, empty classes, both AP modes), the
datasets' `evaluate`, and `evaluate_dataset` of the tiny-fixture detector
with JAX weights carried across by `utils/convert.py`.

Tolerances: the numpy metrics compute the same float64 expressions, so
1e-6 (stated by the task) leaves ample room; the detector's detections
differ by ~1e-5 of scale from summation order, held to 1e-3 as in
`test_torch_detector.py`, and its AP50 to 1e-4.
"""

import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from .torch_port_utils import JAX_PKG, PORT_PKG, fill_variables

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = str(ROOT / 'configs/da/faster_rcnn_r18_tiny_fixture.py')

jmap = importlib.import_module(f'{JAX_PKG}.core.eval.mean_ap')
tmap = importlib.import_module(f'{PORT_PKG}.core.eval.mean_ap')
jdata = importlib.import_module(f'{JAX_PKG}.data')
tdata = importlib.import_module(f'{PORT_PKG}.data')
jtest = importlib.import_module(f'{JAX_PKG}.apis.test')
ttest = importlib.import_module(f'{PORT_PKG}.apis.test')
jbuilder = importlib.import_module(f'{JAX_PKG}.models.builder')
jconfig = importlib.import_module(f'{JAX_PKG}.utils.config')
tinference = importlib.import_module(f'{PORT_PKG}.apis.inference')


def _boxes(rs, n, extent=100.0):
    xy = rs.uniform(0, extent * 0.8, (n, 2))
    wh = rs.uniform(2.0, extent * 0.4, (n, 2))
    return np.concatenate([xy, xy + wh], -1)


def _problem(seed, n_img=6, n_cls=4):
    """Per-image, per-class detections near and away from random gts, some
    gts difficult (ignored); class 3 has no gts, class 2 no detections in
    some images, one image has no gts at all."""
    rs = np.random.RandomState(seed)
    dets, anns = [], []
    for i in range(n_img):
        n = 0 if i == 2 else rs.randint(1, 8)
        gts = _boxes(rs, n).astype(np.float32)
        labels = rs.randint(0, n_cls - 1, n)
        n_ign = rs.randint(0, 3)
        ign = _boxes(rs, n_ign).astype(np.float32)
        anns.append(dict(bboxes=gts, labels=labels, bboxes_ignore=ign,
                         labels_ignore=rs.randint(0, n_cls - 1, n_ign)))
        per_cls = []
        for c in range(n_cls):
            near = gts[labels == c] + rs.normal(0, 4, (int((labels == c)
                                                           .sum()), 4))
            near_ign = ign[anns[-1]['labels_ignore'] == c] + \
                rs.normal(0, 2, (int((anns[-1]['labels_ignore'] == c)
                                     .sum()), 4))
            far = _boxes(rs, rs.randint(0, 4))
            boxes = np.concatenate([near, near_ign, far])
            if c == 2 and i % 2:
                boxes = boxes[:0]
            scores = rs.uniform(0.05, 1, (len(boxes), 1))
            per_cls.append(np.concatenate([boxes, scores], 1)
                           .astype(np.float32))
        dets.append(per_cls)
    return dets, anns


@pytest.mark.parametrize('dataset', [None, 'voc07'])      # area / 11 points
@pytest.mark.parametrize('legacy', [True, False])
@pytest.mark.parametrize('iou_thr', [0.5, 0.7])
@pytest.mark.parametrize('seed', [0, 1])
def test_eval_map_matches(dataset, legacy, iou_thr, seed):
    dets, anns = _problem(seed)
    got, got_cls = tmap.eval_map(dets, anns, iou_thr, dataset, legacy)
    ref, ref_cls = jmap.eval_map(dets, anns, iou_thr, dataset, legacy)
    assert abs(got - ref) <= 1e-6 and 0 < ref < 1
    assert len(got_cls) == len(ref_cls) == 4
    assert ref_cls[3]['num_gts'] == 0
    for g, r in zip(got_cls, ref_cls):
        assert (g['num_gts'], g['num_dets']) == (r['num_gts'], r['num_dets'])
        assert abs(g['ap'] - r['ap']) <= 1e-6
        np.testing.assert_allclose(g['recall'], r['recall'], atol=1e-6)
        np.testing.assert_allclose(g['precision'], r['precision'], atol=1e-6)


@pytest.mark.parametrize('legacy', [True, False])
def test_tpfp_default_matches(legacy):
    dets, anns = _problem(3)
    for per_cls, ann in zip(dets, anns):
        for c, d in enumerate(per_cls):
            gts = ann['bboxes'][ann['labels'] == c]
            ign = ann['bboxes_ignore'][ann['labels_ignore'] == c]
            for thr in (0.3, 0.5):
                got = tmap.tpfp_default(d, gts, ign, thr, legacy)
                ref = jmap.tpfp_default(d, gts, ign, thr, legacy)
                np.testing.assert_array_equal(got[0], ref[0])
                np.testing.assert_array_equal(got[1], ref[1])


@pytest.mark.parametrize('mode', ['area', '11points'])
def test_average_precision_matches(mode):
    rs = np.random.RandomState(0)
    rec = np.sort(rs.uniform(0, 1, (3, 20)), axis=1)
    prec = rs.uniform(0, 1, (3, 20))
    np.testing.assert_allclose(tmap.average_precision(rec, prec, mode),
                               jmap.average_precision(rec, prec, mode),
                               atol=1e-12)
    assert abs(tmap.average_precision(rec[0], prec[0], mode) -
               jmap.average_precision(rec[0], prec[0], mode)) <= 1e-12


@pytest.mark.parametrize('legacy', [True, False])
def test_eval_recalls_matches(legacy):
    dets, anns = _problem(4)
    gts = [a['bboxes'] for a in anns]
    props = [np.vstack(d) for d in dets]
    args = ((1, 3, 10, 100), (0.3, 0.5, 0.7), legacy)
    got = tmap.eval_recalls(gts, props, *args)
    ref = jmap.eval_recalls(gts, props, *args)
    np.testing.assert_allclose(got, ref, atol=1e-6)
    assert ref.max() > 0


def _val(module, cfg_module, *device):
    cfg = cfg_module.Config.fromfile(TINY)
    return module.build_dataset(dict(
        cfg.data['val'],
        ann_file=str(ROOT / 'tests/data/voc_target/ImageSets/Main/test.txt'),
        img_prefix=str(ROOT / 'tests/data/voc_target') + '/'), *device)


@pytest.mark.parametrize('metric', ['mAP', 'recall'])
def test_dataset_evaluate_matches(metric):
    tcfg = importlib.import_module(f'{PORT_PKG}.utils.config')
    got_ds, ref_ds = _val(tdata, tcfg, 'cpu'), _val(jdata, jconfig)
    rs = np.random.RandomState(5)
    results = []
    for i in range(len(ref_ds)):
        ann = ref_ds.get_ann_info(i)
        per_cls = []
        for c in range(2):
            boxes = np.concatenate([ann['bboxes'][ann['labels'] == c] +
                                    rs.normal(0, 1, (int((ann['labels'] == c)
                                                         .sum()), 4)),
                                    _boxes(rs, 2, 60)])
            per_cls.append(np.concatenate(
                [boxes, rs.uniform(0, 1, (len(boxes), 1))], 1)
                .astype(np.float32))
        results.append(per_cls)
    got = got_ds.evaluate(results, metric=metric)
    ref = ref_ds.evaluate(results, metric=metric)
    assert set(got) == set(ref)
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-6, k
    if metric == 'mAP':
        assert 0 < ref['AP50'] <= 1


@pytest.fixture(scope='module')
def tiny_eval():
    """The JAX tiny-fixture detector with seeded numpy weights, and the
    port's loaded from the same weights (as in test_torch_detector.py)."""
    cfg = jconfig.Config.fromfile(TINY)
    model = jbuilder.build_detector(cfg.model)
    b, (h, w) = 2, cfg.canvas
    dummy = dict(image=jnp.zeros((b, h, w, 3)),
                 img_shape=jnp.full((b, 2), h, jnp.int32),
                 gt_bboxes=jnp.zeros((b, 4, 4)),
                 gt_labels=jnp.zeros((b, 4), jnp.int32),
                 gt_valid=jnp.zeros((b, 4), bool),
                 domain=jnp.zeros((b,), jnp.int32))
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: model.init(
        {'params': k, 'sampler': k, 'dropout': k}, dummy, train=True))
    variables = fill_variables(shapes, np.random.RandomState(11))
    bundle = tinference.init_detector(cfg, variables=variables,
                                      device='cpu')
    return model, variables, bundle


def test_evaluate_dataset_matches_jax(tiny_eval):
    model, variables, bundle = tiny_eval
    tcfg = importlib.import_module(f'{PORT_PKG}.utils.config')
    got_ds, ref_ds = _val(tdata, tcfg, 'cpu'), _val(jdata, jconfig)
    ref = jtest.run_inference(model, variables, ref_ds, 2)
    got = ttest.run_inference(bundle.model, got_ds, 2)
    assert len(got) == len(ref) == len(ref_ds)
    assert sum(len(d) for r in ref for d in r) > 0
    for g_img, r_img in zip(got, ref):
        for g, r in zip(g_img, r_img):
            assert g.shape == r.shape and g.dtype == np.float32
            np.testing.assert_allclose(g, r, atol=1e-3)
    got_m = ttest.evaluate_dataset(bundle.model, got_ds, 2)
    ref_m = jtest.evaluate_dataset(model, variables, ref_ds, 2)
    assert set(got_m) == set(ref_m) == {'AP50', 'mAP'}
    assert abs(got_m['AP50'] - ref_m['AP50']) <= 1e-4
    assert abs(got_m['mAP'] - ref_m['mAP']) <= 1e-4


def test_results_from_batch_matches():
    rs = np.random.RandomState(2)
    dets = rs.uniform(0, 50, (2, 6, 5)).astype(np.float32)
    labels = rs.randint(0, 3, (2, 6)).astype(np.int32)
    valid = rs.uniform(0, 1, (2, 6)) > 0.3
    sf = np.array([[0.5, 0.5, 0.5, 0.5], [2, 2, 2, 2]], np.float32)
    got = ttest.results_from_batch(dets, labels, valid, sf, 3)
    ref = jtest.results_from_batch(dets, labels, valid, sf, 3)
    for g_img, r_img in zip(got, ref):
        for g, r in zip(g_img, r_img):
            np.testing.assert_array_equal(g, r)


def test_tta_raises():
    with pytest.raises(NotImplementedError, match='test-time'):
        ttest.run_inference(None, None, flip_tta=True)
    with pytest.raises(NotImplementedError, match='test-time'):
        ttest.run_inference(None, None, scale_tta=(0.75,))
