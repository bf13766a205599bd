"""The port's COCO data path against the JAX package's: `CocoDataset`'s
annotations (class tables, crowd, RLE and ignored instances), its 'bbox'
(COCO protocol) and 'mAP' evaluations on seeded detections,
`RepeatDataset`, and whole loader epochs of the synth Mask R-CNN config
and of the Swin ms-crop-3x pipeline (`AutoAugment` with `RandomCrop`) on
the committed polygon split; plus the checks that the committed polygon
split and the synth clear→foggy set are what the generator writes."""

import importlib
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from .torch_port_utils import JAX_PKG, PORT_PKG, native_library

ROOT = pathlib.Path(__file__).resolve().parent.parent
SEG = ROOT / 'tests/data/synth_seg'
SYNTH_DA = ROOT / 'tests/data/synth_da'
MASK_CONFIG = 'configs/da/synth_mask_smoke.py'
MS_CROP_CONFIG = 'configs/swin/mask_rcnn_swin-t-p4-w7_fpn_ms-crop-3x.py'

jdata = importlib.import_module(f'{JAX_PKG}.data')
jconfig = importlib.import_module(f'{JAX_PKG}.utils.config')
tdata = importlib.import_module(f'{PORT_PKG}.data')
tconfig = importlib.import_module(f'{PORT_PKG}.utils.config')


def seg_overrides(keys=('data.train', 'data.val', 'data.test'),
                  ann='test.json', classes=True):
    """Dotted overrides pointing each split of a COCO config at the
    committed polygon split (its 50-image test half unless `ann` says)."""
    out = {}
    for key in keys:
        out[f'{key}.ann_file'] = str(SEG / ann)
        out[f'{key}.img_prefix'] = f'{SEG}/images/'
        if classes:
            out[f'{key}.classes'] = ('square', 'circle')
    return out


def _configs(path, over):
    cfgs = []
    for mod in (tconfig, jconfig):
        cfg = mod.Config.fromfile(str(ROOT / path))
        cfg.merge_from_dict(over)
        cfgs.append(cfg)
    return cfgs


@pytest.fixture(scope='module')
def generated(tmp_path_factory):
    """The generator's default call with `--coco-masks` (seed 0, 200 train
    and 50 test images a domain): the polygon split and both VOC domains,
    whose `shapes_clear/` equals the call without the flag's."""
    pytest.importorskip('PIL')
    out = tmp_path_factory.mktemp('generated')
    subprocess.run([sys.executable,
                    str(ROOT / 'tools/misc/make_synthetic_da_dataset.py'),
                    str(out), '--coco-masks'], check=True,
                   capture_output=True)
    return out


def test_committed_split_is_what_the_generator_writes(generated):
    made = generated / 'shapes_seg'
    for split in ('train.json', 'test.json'):
        assert json.loads((made / split).read_text()) == \
            json.loads((SEG / split).read_text())
    for name in ('train_0000.jpg', 'train_0137.jpg', 'test_0049.jpg'):
        assert (made / 'images' / name).read_bytes() == \
            (SEG / 'images' / name).read_bytes()
    assert len(list((SEG / 'images').iterdir())) == 250


@pytest.mark.parametrize('domain', ['shapes_clear', 'shapes_foggy'])
def test_committed_synth_da_set_is_what_the_generator_writes(generated,
                                                             domain):
    """tests/data/synth_da: each domain's image lists and annotations
    equal the generator's, three named JPEGs are byte-equal, and the
    domain holds 250 JPEGs."""
    made, ours = generated / domain, SYNTH_DA / domain
    for split in ('train', 'test'):
        txt = f'ImageSets/Main/{split}.txt'
        assert (made / txt).read_text() == (ours / txt).read_text()
    xmls = sorted(p.name for p in (made / 'Annotations').iterdir())
    assert xmls == sorted(p.name for p in (ours / 'Annotations').iterdir())
    assert len(xmls) == 250
    for name in xmls:
        assert (made / 'Annotations' / name).read_bytes() == \
            (ours / 'Annotations' / name).read_bytes(), name
    for name in ('train_0000.jpg', 'train_0137.jpg', 'test_0049.jpg'):
        assert (made / 'JPEGImages' / name).read_bytes() == \
            (ours / 'JPEGImages' / name).read_bytes(), name
    assert len(list((ours / 'JPEGImages').glob('*.jpg'))) == 250


def _write_json(path, cats, anns, n_images=3):
    images = [dict(id=i + 1, file_name=f'test_{i:04d}.jpg', width=192,
                   height=128) for i in range(n_images)]
    path.write_text(json.dumps(dict(images=images, annotations=anns,
                                    categories=cats)))
    return str(path)


def _edge_json(tmp_path):
    """Three images: crowd boxes, an RLE segmentation, an `ignore`d
    annotation, a category outside a `classes=` subset, an image whose
    annotations all drop, and categories listed out of id order."""
    cats = [dict(id=3, name='circle'), dict(id=1, name='square'),
            dict(id=7, name='triangle')]
    poly = [10.0, 10.0, 40.0, 10.0, 25.0, 40.0]
    anns = [
        dict(id=1, image_id=1, category_id=1, bbox=[10, 10, 30, 30],
             iscrowd=0, segmentation=[poly]),
        dict(id=2, image_id=1, category_id=3, bbox=[50, 20, 20, 25],
             iscrowd=1, segmentation=dict(counts=[1, 2], size=[128, 192])),
        dict(id=3, image_id=1, category_id=7, bbox=[60, 60, 10, 10],
             iscrowd=0, segmentation=[poly]),
        dict(id=4, image_id=2, category_id=3, bbox=[5, 6, 7, 8], iscrowd=0,
             segmentation=dict(counts='abc', size=[128, 192])),
        dict(id=5, image_id=2, category_id=1, bbox=[1, 1, 5, 5], iscrowd=0,
             ignore=1, segmentation=[poly]),
        dict(id=6, image_id=3, category_id=7, bbox=[2, 2, 9, 9], iscrowd=0,
             segmentation=[poly]),
    ]
    return _write_json(tmp_path / 'edge.json', cats, anns)


@pytest.mark.parametrize('case', ['synth', 'synth_no_classes', 'edge',
                                  'edge_subset', 'edge_test_mode'])
def test_load_annotations_match(case, tmp_path):
    kw = dict(pipeline=[], img_prefix=f'{SEG}/images/')
    if case.startswith('synth'):
        kw['ann_file'] = str(SEG / 'train.json')
        if case == 'synth':
            kw['classes'] = ('square', 'circle')
    else:
        kw['ann_file'] = _edge_json(tmp_path)
        if case == 'edge_subset':
            kw['classes'] = ('square', 'circle')
        kw['test_mode'] = case == 'edge_test_mode'
    got = tdata.build_dataset(dict(type='CocoDataset', **kw), 'cpu')
    ref = jdata.build_dataset(dict(type='CocoDataset', **kw))
    assert got.CLASSES == ref.CLASSES and len(got) == len(ref) > 0
    for g, r in zip(got.data_infos, ref.data_infos):
        assert set(g) == set(r) and set(g['ann']) == set(r['ann'])
        for k in r:
            if k != 'ann':
                assert g[k] == r[k], k
        for k, v in r['ann'].items():
            if isinstance(v, np.ndarray):
                assert g['ann'][k].dtype == v.dtype
                assert np.array_equal(g['ann'][k], v), k
            else:
                assert g['ann'][k] == v, k


def _detections(rs, dataset, n_classes):
    """Per image, per class (n, 5) detections: jittered gt boxes (some
    hits at every IoU), boxes over crowd regions, and random false
    positives at all areas, with seeded scores."""
    out = []
    for i in range(len(dataset)):
        ann = dataset.get_ann_info(i)
        per = []
        for c in range(n_classes):
            g = np.concatenate([ann['bboxes'][ann['labels'] == c],
                                ann['bboxes_ignore'][ann['labels_ignore']
                                                     == c]])
            jit = g + rs.normal(0, 3, g.shape)
            fp = rs.uniform(0, 150, (rs.randint(0, 4), 2))
            fp = np.concatenate([fp, fp + rs.uniform(2, 120, fp.shape)], 1)
            boxes = np.concatenate([jit, fp]).reshape(-1, 4)
            scores = rs.uniform(0, 1, (len(boxes), 1))
            per.append(np.concatenate([boxes, scores], 1).astype(np.float32))
        out.append(per)
    return out


@pytest.mark.parametrize('ann', ['test', 'edge'])
def test_evaluate_bbox_and_map_match(ann, tmp_path):
    kw = dict(pipeline=[], img_prefix='', test_mode=True)
    kw['ann_file'] = str(SEG / 'test.json') if ann == 'test' \
        else _edge_json(tmp_path)
    got = tdata.build_dataset(dict(type='CocoDataset', **kw), 'cpu')
    ref = jdata.build_dataset(dict(type='CocoDataset', **kw))
    dets = _detections(np.random.RandomState(3), ref, len(ref.CLASSES))
    g, r = got.evaluate(dets, metric='bbox'), ref.evaluate(dets,
                                                           metric='bbox')
    assert set(g) == set(r) == {'bbox_mAP', 'bbox_mAP_50', 'bbox_mAP_75',
                                'bbox_mAP_s', 'bbox_mAP_m', 'bbox_mAP_l'}
    for k in r:
        assert abs(g[k] - r[k]) <= 1e-6, k
    assert 0 < r['bbox_mAP'] < r['bbox_mAP_50'] <= 1
    assert got.evaluate(dets, metric='mAP') == ref.evaluate(dets,
                                                            metric='mAP')
    with pytest.raises(KeyError):
        got.evaluate(dets, metric='segm')


def test_repeat_dataset_matches():
    sub = dict(type='CocoDataset', ann_file=str(SEG / 'test.json'),
               img_prefix=f'{SEG}/images/', classes=('square', 'circle'),
               pipeline=[dict(type='LoadImageFromFile'),
                         dict(type='LoadAnnotations', with_mask=True,
                              mask_size=28),
                         dict(type='RandomFlip', flip_ratio=0.5)])
    got = tdata.build_dataset(dict(type='RepeatDataset', times=3,
                                   dataset=sub), 'cpu')
    ref = jdata.build_dataset(dict(type='RepeatDataset', times=3,
                                   dataset=sub))
    assert len(got) == len(ref) == 150 and got.CLASSES == ref.CLASSES
    assert got.dataset.device == torch.device('cpu')
    for i in (0, 49, 50, 149, 3):
        g, r = got[i], ref[i]
        assert g['flip'] == r['flip']
        assert np.array_equal(g['img'].numpy(), r['img'])
        for k in ('gt_bboxes', 'gt_labels', 'gt_masks'):
            assert np.array_equal(g[k], r[k]), (i, k)
        a, b = got.get_ann_info(i), ref.get_ann_info(i)
        assert np.array_equal(a['bboxes'], b['bboxes'])


def _compare(g, r, n, image_atol=0.0):
    assert set(g) == set(r), n
    for k in r:
        gk = g[k].numpy()
        rk = np.asarray(r[k]).astype(gk.dtype)
        if k == 'image' and image_atol:
            assert gk.shape == rk.shape
            assert np.abs(gk - rk).max() <= image_atol, n
        else:
            assert np.array_equal(gk, rk), (n, k)


def _same_batches(got, ref, epochs=2):
    """The port's batches over `epochs` epochs, each held to the JAX
    loader's."""
    batches = []
    for _ in range(epochs):
        for g, r in zip(got, ref):
            _compare(g, r, len(batches))
            batches.append(g)
    return batches


def test_mask_loader_batches_match_for_two_epochs():
    """The synth Mask R-CNN config's loader (56² rasters, flips, batch 8)
    over the committed test half, both packages, two epochs, exact."""
    native_library()   # the JAX uint8 resize must be the native one
    tcfg, jcfg = _configs(MASK_CONFIG, seg_overrides(('data.train',)))
    spb = tcfg.data['samples_per_gpu']
    got = tdata.DataLoader(tdata.build_dataset(tcfg.data['train'], 'cpu'),
                           spb, seed=0)
    ref = jdata.DataLoader(jdata.build_dataset(jcfg.data['train']), spb,
                           seed=0)
    assert len(got) == len(ref) == 6
    batches = _same_batches(got, ref)
    assert len(batches) == 12
    for b in batches:
        assert b['gt_masks'].shape == (8, 10, 56, 56)
        assert b['gt_masks'].dtype == torch.uint8
    assert 0 < torch.cat([b['flip'] for b in batches]).sum() < 96


def test_ms_crop_pipeline_batches_match_jax_up_to_its_failure(tmp_path):
    """The Swin ms-crop-3x train pipeline as configured (AutoAugment over a
    multi-scale Resize and Resize / range RandomCrop / Resize, padded to
    800x1344) on 8 committed images in batches of 2: policies, crops,
    boxes, labels and validity exact; the upscaled images within one grey
    level (the resizes, as in `test_torch_pipeline.py`). A crop taller
    than wide, resized to the policy's scales, exceeds the config's fixed
    canvas: both packages raise there, at the same sample, with the same
    error."""
    native_library()   # the JAX uint8 resize must be the native one
    coco = json.loads((SEG / 'test.json').read_text())
    keep = {im['id'] for im in coco['images'][:8]}
    coco['images'] = coco['images'][:8]
    coco['annotations'] = [a for a in coco['annotations']
                           if a['image_id'] in keep]
    (tmp_path / 'eight.json').write_text(json.dumps(coco))
    over = {'data.train.ann_file': str(tmp_path / 'eight.json'),
            'data.train.img_prefix': f'{SEG}/images/',
            'data.train.classes': ('square', 'circle')}
    tcfg, jcfg = _configs(MS_CROP_CONFIG, over)
    got = tdata.DataLoader(tdata.build_dataset(tcfg.data['train'], 'cpu'), 2,
                           seed=0, prefetch=0)
    ref = jdata.DataLoader(jdata.build_dataset(jcfg.data['train']), 2,
                           seed=0, prefetch=0)
    n = 0
    with pytest.raises(ValueError, match='exceeds the fixed canvas') as err:
        for _ in range(2):
            j_it = iter(ref)
            for g in got:
                _compare(g, next(j_it), n, image_atol=1.0 / 57.0 + 1e-5)
                assert g['image'].shape == (2, 800, 1344, 3)
                assert 'gt_masks' not in g    # its PackDetInputs keeps none
                n += 1
    # the JAX loader stops at the same sample, with the same error
    with pytest.raises(ValueError) as jerr:
        next(j_it)
    assert str(err.value) == str(jerr.value) and n > 0, n
