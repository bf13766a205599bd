"""The port's training data path against the JAX package's, on the same
configs and seeds: VOC-XML datasets, each train transform with its random
draws, multi-scale `Resize`, the batch samplers and whole `DataLoader`
epochs, on the tiny fixture config and on the committed synth subset.

Everything here is exact (`np.array_equal`), images included: decode is
bit-equal to the JAX package's cv2/PIL read, and at these configs' scales
(the image's own size) both resizes are the identity; a resize that does
change the size is held to one grey level as in `test_torch_pipeline.py`.
"""

import importlib
import pathlib

import numpy as np
import pytest
import torch

from .torch_port_utils import JAX_PKG, PORT_PKG, SYNTH_CONFIG, synth_overrides

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = 'configs/da/faster_rcnn_r18_tiny_fixture.py'

jdata = importlib.import_module(f'{JAX_PKG}.data')
jtf = importlib.import_module(f'{JAX_PKG}.data.pipelines.transforms')
jsamplers = importlib.import_module(f'{JAX_PKG}.data.samplers.two_stream')
jconfig = importlib.import_module(f'{JAX_PKG}.utils.config')
tdata = importlib.import_module(f'{PORT_PKG}.data')
ttf = importlib.import_module(f'{PORT_PKG}.data.pipelines.transforms')
tsamplers = importlib.import_module(f'{PORT_PKG}.data.samplers.two_stream')
tconfig = importlib.import_module(f'{PORT_PKG}.utils.config')


def _configs(name):
    """(port config, JAX config) of the tiny fixture or the synth subset,
    with paths absolute so the tests run from any directory."""
    if name == 'tiny':
        path = TINY
        over = {}
        for key, sub in (('data.train.datasets.0', 'voc_source'),
                         ('data.train.datasets.1', 'voc_target'),
                         ('data.val', 'voc_target'),
                         ('data.test', 'voc_target')):
            split = 'train' if 'train' in key else 'test'
            over[f'{key}.ann_file'] = \
                f'{ROOT}/tests/data/{sub}/ImageSets/Main/{split}.txt'
            over[f'{key}.img_prefix'] = f'{ROOT}/tests/data/{sub}/'
    else:
        path, over = SYNTH_CONFIG, synth_overrides(ROOT)
    cfgs = []
    for mod in (tconfig, jconfig):
        cfg = mod.Config.fromfile(str(ROOT / path))
        cfg.merge_from_dict(over)
        cfgs.append(cfg)
    return cfgs


def _split(cfg, which):
    return cfg.data['train']['datasets'][int(which)] if which in '01' \
        else cfg.data[which]


def _assert_same(got, ref, what=''):
    if isinstance(ref, dict):
        assert set(got) == set(ref), what
        for k in ref:
            _assert_same(got[k], ref[k], f'{what}.{k}')
    elif isinstance(ref, list):
        assert len(got) == len(ref), what
        for i, (g, r) in enumerate(zip(got, ref)):
            _assert_same(g, r, f'{what}[{i}]')
    elif isinstance(got, torch.Tensor):
        g = got.numpy()
        assert np.array_equal(g, np.asarray(ref).astype(g.dtype)), what
    elif isinstance(ref, np.ndarray):
        assert got.dtype == ref.dtype and np.array_equal(got, ref), what
    else:
        assert got == ref, what


@pytest.mark.parametrize('name', ['tiny', 'synth'])
@pytest.mark.parametrize('which', ['0', '1', 'val'])
def test_datasets_match(name, which):
    tcfg, jcfg = _configs(name)
    got = tdata.build_dataset(_split(tcfg, which), 'cpu')
    ref = jdata.build_dataset(_split(jcfg, which))
    assert len(got) == len(ref) > 0
    assert got.CLASSES == ref.CLASSES and got.domain == ref.domain
    _assert_same(got.data_infos, ref.data_infos)
    for i in range(len(ref)):
        _assert_same(got.get_ann_info(i), ref.get_ann_info(i))


@pytest.mark.parametrize('which', ['0', 'train'])
def test_datasets_default_to_the_card(which):
    """A dataset (and the ConcatDataset of the train split) is built for
    CUDA unless the caller asks for the CPU, and raises without a card."""
    split = _split(_configs('tiny')[0], which)
    if torch.cuda.is_available():
        ds = tdata.build_dataset(split)
        assert getattr(ds, 'datasets', [ds])[0].device.type == 'cuda'
        return
    for device in ((), ('cuda',)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tdata.build_dataset(split, *device)


def test_difficult_small_and_unknown_objects(tmp_path):
    """Difficult objects and boxes under `min_size` go to the ignored set,
    unknown classes are dropped, coordinates become 0-based; images left
    without gts are filtered unless `test_mode`."""
    (tmp_path / 'Annotations').mkdir()
    objs = [('car', 0, (11, 21, 40, 60)), ('person', 1, (5, 5, 30, 30)),
            ('car', 0, (50, 50, 53, 80)), ('truck', 0, (1, 1, 9, 9))]
    xml = ['<annotation><size><width>96</width><height>64</height></size>']
    for name, diff, (x1, y1, x2, y2) in objs:
        xml.append(f'<object><name>{name}</name><difficult>{diff}</difficult>'
                   f'<bndbox><xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}'
                   f'</xmax><ymax>{y2}</ymax></bndbox></object>')
    (tmp_path / 'Annotations/a.xml').write_text(''.join(xml) +
                                                '</annotation>')
    (tmp_path / 'Annotations/b.xml').write_text(
        '<annotation><size><width>8</width><height>8</height></size>'
        '</annotation>')
    (tmp_path / 'ids.txt').write_text('a\nb\n')
    kw = dict(ann_file=str(tmp_path / 'ids.txt'), img_prefix=str(tmp_path),
              classes=('car', 'person'), pipeline=[], min_size=8)
    for test_mode in (False, True):
        got = tdata.build_dataset(dict(type='DADataset', test_mode=test_mode,
                                       **kw), 'cpu')
        ref = jdata.build_dataset(dict(type='DADataset', test_mode=test_mode,
                                       **kw))
        assert len(got) == len(ref) == (2 if test_mode else 1)
        _assert_same(got.data_infos, ref.data_infos)
    ann = got.get_ann_info(0)
    np.testing.assert_array_equal(ann['bboxes'], [[10, 20, 39, 59]])
    assert len(ann['bboxes_ignore']) == 2


@pytest.mark.parametrize('name', ['tiny', 'synth'])
def test_each_train_transform_matches_with_the_same_draws(name):
    """The train pipeline one transform at a time, on several images of
    one dataset, both sides drawing from RandomStates in the same state:
    results and RNG states equal after every step."""
    tcfg, jcfg = _configs(name)
    tds = tdata.build_dataset(_split(tcfg, '0'), 'cpu')
    jds = jdata.build_dataset(_split(jcfg, '0'))
    for i in range(min(len(jds), 6)):
        info = jds.data_infos[i]
        base = dict(img_info=info, ann_info=jds.get_ann_info(i),
                    img_prefix=jds.img_prefix, domain=jds.domain)
        tres = dict(base, _rng=tds._rng, device=tds.device)
        jres = dict(base, _rng=jds._rng)
        for tt, jt in zip(tds.pipeline.transforms, jds.pipeline.transforms):
            assert type(tt).__name__ == type(jt).__name__
            tres, jres = tt(tres), jt(jres)
            assert np.array_equal(tds._rng.get_state()[1],
                                  jds._rng.get_state()[1])
            for k in jres:
                if k in ('_rng', 'ann_info', 'img_info', 'img_norm_cfg'):
                    continue
                _assert_same(tres[k], jres[k], f'{type(jt).__name__}.{k}')


@pytest.mark.parametrize('mode,scales,ratio', [
    ('value', [(96, 64), (120, 80), (72, 48)], None),
    ('range', [(96, 64), (160, 100)], None),
    ('range', [(96, 64)], (0.5, 1.5)),
    ('value', [(120, 80), (80, 60)], (0.8, 1.2)),
])
def test_multiscale_resize_matches(mode, scales, ratio):
    """`Resize` with a list of scales (and a ratio range): the same draws,
    the same sizes and boxes on both sides; images within one grey level
    (the JAX resize is its native C++ one, the port's copies its
    algorithm)."""
    rs = np.random.RandomState(0)
    t_rng, j_rng = np.random.RandomState(7), np.random.RandomState(7)
    kw = dict(img_scale=scales, multiscale_mode=mode, ratio_range=ratio)
    for _ in range(5):
        img = rs.randint(0, 256, (64, 96, 3)).astype(np.uint8)
        boxes = np.array([[3, 4, 50, 60], [10, 2, 95, 63]], np.float32)
        j = jtf.Resize(**kw)(dict(img=img, gt_bboxes=boxes.copy(),
                                  _rng=j_rng))
        t = ttf.Resize(**kw)(dict(img=torch.from_numpy(img),
                                  gt_bboxes=boxes.copy(), _rng=t_rng))
        assert t['img_shape'] == tuple(j['img_shape'])
        assert np.array_equal(t['scale_factor'], j['scale_factor'])
        assert np.array_equal(t['gt_bboxes'], j['gt_bboxes'])
        assert np.abs(t['img'].numpy().astype(int) -
                      j['img'].astype(int)).max() <= 1
        assert np.array_equal(t_rng.get_state()[1], j_rng.get_state()[1])


def test_random_flip_draws_and_boxes_match():
    rs = np.random.RandomState(1)
    t_rng, j_rng = np.random.RandomState(3), np.random.RandomState(3)
    flips = []
    for _ in range(12):
        img = rs.randint(0, 256, (20, 30, 3)).astype(np.uint8)
        boxes = np.array([[2, 3, 11, 17], [0, 0, 30, 20]], np.float32)
        meta = dict(img_shape=(20, 30))
        j = jtf.RandomFlip(0.5)(dict(meta, img=img, gt_bboxes=boxes,
                                     _rng=j_rng))
        t = ttf.RandomFlip(0.5)(dict(meta, img=torch.from_numpy(img),
                                     gt_bboxes=boxes, _rng=t_rng))
        assert t['flip'] == j['flip']
        assert np.array_equal(t['img'].numpy(), j['img'])
        assert np.array_equal(t['gt_bboxes'], j['gt_bboxes'])
        flips.append(t['flip'])
    assert 0 < sum(flips) < len(flips)


def test_multiscaleflipaug_and_masks_raise_as_jax():
    inner = [dict(type='Resize', img_scale=(96, 64))]
    assert isinstance(ttf.MultiScaleFlipAug(inner, img_scale=(96, 64))
                      .inner.transforms[0], ttf.Resize)
    for kw in (dict(flip=True), dict(img_scale=[(96, 64), (120, 80)])):
        with pytest.raises(NotImplementedError):
            jtf.MultiScaleFlipAug(inner, **kw)
        with pytest.raises(NotImplementedError):
            ttf.MultiScaleFlipAug(inner, **kw)
    with pytest.raises(NotImplementedError, match='mask'):
        ttf.LoadAnnotations(with_mask=True)


@pytest.mark.parametrize('src,tgt,batch,steps', [(4, 3, 2, None),
                                                 (16, 16, 8, None),
                                                 (5, 11, 4, 7)])
def test_two_stream_sampler_indices_match(src, tgt, batch, steps):
    got = tsamplers.TwoStreamBatchSampler(src, tgt, batch, 3, steps)
    ref = jsamplers.TwoStreamBatchSampler(src, tgt, batch, 3, steps)
    assert len(got) == len(ref)
    for _ in range(3):
        assert list(got) == list(ref)


@pytest.mark.parametrize('size,batch,shuffle,drop_last', [
    (7, 2, True, True), (7, 2, True, False), (8, 3, False, False),
    (33, 8, True, False)])
def test_group_sampler_indices_match(size, batch, shuffle, drop_last):
    got = tsamplers.GroupBatchSampler(size, batch, shuffle, 5, drop_last)
    ref = jsamplers.GroupBatchSampler(size, batch, shuffle, 5, drop_last)
    assert len(got) == len(ref)
    for _ in range(3):
        assert list(got) == list(ref)


@pytest.mark.parametrize('name', ['tiny', 'synth'])
def test_loader_batches_match_for_two_epochs(name):
    """The two-stream loaders of both packages, same config and seed: two
    epochs of batches, every key exact (image included)."""
    tcfg, jcfg = _configs(name)
    spb = tcfg.data['samples_per_gpu']
    got = tdata.DataLoader(tdata.build_dataset(tcfg.data['train'], 'cpu'),
                           spb, seed=0)
    ref = jdata.DataLoader(jdata.build_dataset(jcfg.data['train']), spb,
                           seed=0)
    assert got.two_stream and ref.two_stream and len(got) == len(ref)
    n = 0
    for _ in range(2):
        for g, r in zip(got, ref):
            _assert_same(g, r, f'batch {n}')
            assert (g['domain'].numpy() == [0, 1] * (spb // 2)).all()
            n += 1
    assert n == 2 * len(ref)


def test_the_test_loader_and_a_failing_sample():
    """An in-order loader over the val set fills its last batch from the
    start, as the JAX one; an error inside the background thread reaches
    the caller."""
    tcfg, jcfg = _configs('tiny')
    tds = tdata.build_dataset(tcfg.data['val'], 'cpu')
    jds = jdata.build_dataset(jcfg.data['val'])
    kw = dict(shuffle=False, two_stream=False, drop_last=False)
    for g, r in zip(tdata.DataLoader(tds, 2, **kw),
                    jdata.DataLoader(jds, 2, **kw)):
        _assert_same(g, r)
    tds.data_infos[-1] = dict(tds.data_infos[-1], filename='missing.jpg')
    with pytest.raises(FileNotFoundError):
        list(tdata.DataLoader(tds, 2, **kw))


def test_concat_dataset_locates_like_jax():
    tcfg, jcfg = _configs('synth')
    got = tdata.build_dataset(tcfg.data['train'], 'cpu')
    ref = jdata.build_dataset(jcfg.data['train'])
    assert got.cumulative_sizes == ref.cumulative_sizes == [16, 32]
    for i in (0, 15, 16, 31):
        _assert_same(got.get_ann_info(i), ref.get_ann_info(i))
