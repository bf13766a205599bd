"""The port's loop on COCO data: `tools.train` of the synth Mask R-CNN
config on 2 committed polygon images (one step, an evaluation, a
checkpoint) and `tools.test --eval bbox` on its checkpoint; and the Swin
ms-crop-3x config, whose `PackDetInputs` keeps no masks, failing on its
first train step in both packages."""

import importlib
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from .torch_port_utils import JAX_PKG, PORT_PKG

ROOT = pathlib.Path(__file__).resolve().parent.parent
SEG = ROOT / 'tests/data/synth_seg'
MASK_CONFIG = str(ROOT / 'configs/da/synth_mask_smoke.py')
MS_CROP_CONFIG = str(ROOT /
                     'configs/swin/mask_rcnn_swin-t-p4-w7_fpn_ms-crop-3x.py')

jbuilder = importlib.import_module(f'{JAX_PKG}.models.builder')
jconfig = importlib.import_module(f'{JAX_PKG}.utils.config')
jdata = importlib.import_module(f'{JAX_PKG}.data')
tdata = importlib.import_module(f'{PORT_PKG}.data')
tconfig = importlib.import_module(f'{PORT_PKG}.utils.config')
ttrain = importlib.import_module(f'{PORT_PKG}.apis.train')
ttools_train = importlib.import_module(f'{PORT_PKG}.tools.train')
ttools_test = importlib.import_module(f'{PORT_PKG}.tools.test')


def _eight_images(tmp_path, n=8):
    """The committed test half cut to its first `n` images."""
    coco = json.loads((SEG / 'test.json').read_text())
    keep = {im['id'] for im in coco['images'][:n]}
    coco['images'] = coco['images'][:n]
    coco['annotations'] = [a for a in coco['annotations']
                           if a['image_id'] in keep]
    path = tmp_path / f'first_{n}.json'
    path.write_text(json.dumps(coco))
    return str(path)


def _split_options(ann, splits=('train', 'val', 'test')):
    return [opt for s in splits for opt in (
        f'data.{s}.ann_file={ann}', f'data.{s}.img_prefix={SEG}/images/')]


def test_mask_rcnn_trains_and_tests_from_its_coco_config(tmp_path):
    """One epoch of one step of 2 images with their 56² rasters (32 RoIs
    an image for the heads; the config's 8 images a step at full width
    run on the card), an evaluation of the 2 images after it with the
    loop's 'mAP' whatever `evaluation.metric` says (as the JAX loop), a
    checkpoint, then `tools.test --eval bbox` on it with the
    COCO-protocol keys."""
    ann = _eight_images(tmp_path, 2)
    wd = tmp_path / 'work'
    metrics = ttools_train.main([
        MASK_CONFIG, '--work-dir', str(wd), '--device', 'cpu',
        '--cfg-options', *_split_options(ann), 'runner.max_epochs=1',
        'evaluation.interval=1', 'evaluation.metric=bbox',
        'model.roi_train_cfg.num_samples=32', 'data.samples_per_gpu=2'])
    assert set(metrics) == {'AP50', 'mAP'}
    log = [json.loads(line) for line in open(wd / 'train_log.jsonl')]
    train = [r for r in log if r['mode'] == 'train']
    assert [(r['epoch'], r['iter']) for r in train] == [(1, 1)]
    assert np.isfinite(train[0]['loss_mask']) and train[0]['loss_mask'] > 0
    assert [r['mode'] for r in log] == ['train', 'val']
    out = ttools_test.main([MASK_CONFIG, str(wd / 'ckpt_1'), '--device',
                            'cpu', '--eval', 'bbox', '--cfg-options',
                            *_split_options(ann, ('test',))])
    assert set(out) == {'bbox_mAP', 'bbox_mAP_50', 'bbox_mAP_75',
                        'bbox_mAP_s', 'bbox_mAP_m', 'bbox_mAP_l'}
    assert all(0 <= v <= 1 for v in out.values())


def _first_batches(tmp_path):
    """The ms-crop-3x config's first train batch of 2 from each package's
    loader, on 8 committed images."""
    over = {'data.train.ann_file': _eight_images(tmp_path),
            'data.train.img_prefix': f'{SEG}/images/',
            'data.train.classes': ('square', 'circle')}
    out = []
    for mod, data, args in ((tconfig, tdata, ('cpu',)),
                            (jconfig, jdata, ())):
        cfg = mod.Config.fromfile(MS_CROP_CONFIG)
        cfg.merge_from_dict(over)
        loader = data.DataLoader(data.build_dataset(cfg.data['train'], *args),
                                 2, seed=0, prefetch=0)
        out.append((cfg, next(iter(loader))))
    return out


def test_ms_crop_config_fails_its_first_step_without_masks(tmp_path):
    """The config's `PackDetInputs` has no `with_mask`, so its batches
    carry no `gt_masks`: the JAX Mask R-CNN loss raises a KeyError on the
    first step (traced with `jax.eval_shape`, nothing compiled), and the
    port's step raises one that names the missing option, before any
    forward pass."""
    (tcfg, tbatch), (jcfg, jbatch) = _first_batches(tmp_path)
    assert 'gt_masks' not in tbatch and 'gt_masks' not in jbatch
    model = jbuilder.build_detector(jcfg.model)
    spec = {k: jax.ShapeDtypeStruct(np.shape(v), np.asarray(v).dtype)
            for k, v in jbatch.items()}
    k = jax.random.PRNGKey(0)

    def loss(batch):
        variables = model.init({'params': k, 'sampler': k, 'dropout': k},
                               batch, train=False)
        return model.apply(variables, batch, train=True, rngs={
            'sampler': k, 'dropout': k}, mutable=['batch_stats'])
    with pytest.raises(KeyError, match='gt_masks'):
        jax.eval_shape(loss, spec)

    trainer = ttrain.init_trainer(tcfg, device='cpu', steps_per_epoch=1)
    with pytest.raises(KeyError, match='with_mask=True'):
        trainer.step(trainer.state, tbatch, torch.Generator().manual_seed(0))


def test_mask_rcnn_step_takes_an_image_without_boxes(tmp_path):
    """A negative `RandomCrop` can leave an image of the batch without a
    valid gt; a Mask R-CNN step on such a batch (a loader batch of the
    synth config, its second image's gts marked invalid) gives finite
    losses and moves the parameters."""
    cfg = tconfig.Config.fromfile(MASK_CONFIG)
    cfg.merge_from_dict({'data.train.ann_file': _eight_images(tmp_path),
                         'data.train.img_prefix': f'{SEG}/images/',
                         'model.roi_train_cfg.num_samples': 32})
    batch = next(iter(tdata.DataLoader(
        tdata.build_dataset(cfg.data['train'], 'cpu'), 2, seed=0,
        prefetch=0)))
    batch['gt_valid'][1] = False
    trainer = ttrain.init_trainer(cfg, device='cpu', steps_per_epoch=1)
    before = {n: p.detach().clone() for n, p in trainer.state.params.items()}
    state, metrics = trainer.step(trainer.state, batch,
                                  torch.Generator().manual_seed(0))
    assert all(torch.isfinite(v).all() for v in metrics.values())
    assert metrics['loss_mask'] > 0
    assert any(not torch.equal(p, before[n])
               for n, p in state.params.items())
