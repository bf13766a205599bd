"""The port's synth-row tool (`tools/synth_da_runs.py`): each row's
command line reads only the committed clear→foggy set
(`tests/data/synth_da`), trains and evaluates on the images its row names,
and builds the model type and schedule that the same `--cfg-options`
build in the JAX package's config reader; and a CPU rehearsal of the tool
whose stop after epoch 1 and resume give the records of a run without a
stop."""

import importlib
import json
import pathlib

import pytest
import torch

from .torch_port_utils import JAX_PKG, NARROW_OPTIONS, PORT_PKG

ROOT = pathlib.Path(__file__).resolve().parent.parent
SYNTH_DA = 'tests/data/synth_da'
SMALL = ROOT / 'tests/data/synth_da_small'

jconfig = importlib.import_module(f'{JAX_PKG}.utils.config')
tconfig = importlib.import_module(f'{PORT_PKG}.utils.config')
tdata = importlib.import_module(f'{PORT_PKG}.data')
ttools_train = importlib.import_module(f'{PORT_PKG}.tools.train')
runs = importlib.import_module(f'{PORT_PKG}.tools.synth_da_runs')

# the table of the rows: what each trains on and evaluates on, its model
# type, epochs and lr steps
TABLE = {
    'source_only': (('shapes_clear',), 'shapes_foggy', 'FasterRCNN', 30,
                    [25]),
    'daf': (('shapes_clear', 'shapes_foggy'), 'shapes_foggy',
            'DAFasterRCNN', 30, [25]),
    'oracle': (('shapes_foggy',), 'shapes_foggy', 'FasterRCNN', 30, [25]),
    'swda': (('shapes_clear', 'shapes_foggy'), 'shapes_foggy',
             'FasterRCNN_SWDA', 60, [45, 55]),
    'cascade': (('shapes_clear',), 'shapes_clear', 'CascadeRCNN', 15, [12]),
    'fpn': (('shapes_clear',), 'shapes_clear', 'FasterRCNNFPN', 15, [12]),
    'double_head': (('shapes_clear',), 'shapes_clear', 'DoubleHeadRCNN', 15,
                    [12]),
    'grid': (('shapes_clear',), 'shapes_clear', 'GridRCNN', 15, [12]),
    'dynamic': (('shapes_clear',), 'shapes_clear', 'DynamicRCNN', 30, [12]),
    'crpn_faster': (('shapes_clear',), 'shapes_clear', 'CRPNFasterRCNN', 15,
                    [12]),
    'ga_faster': (('shapes_clear',), 'shapes_clear', 'GAFasterRCNN', 15,
                  [12]),
    'ga_retina': (('shapes_clear',), 'shapes_clear', 'GARetinaNet', 15,
                  [12]),
    **{name: (('shapes_clear',), 'shapes_clear', model_type, 15, [12])
       for name, model_type in (
           ('retinanet', 'RetinaNet'), ('retinanet_fit', 'RetinaNet'),
           ('fcos', 'FCOS'), ('atss', 'ATSS'), ('gfl', 'GFL'),
           ('gfl_fit', 'GFL'), ('paa', 'PAA'), ('free_anchor', 'FreeAnchor'),
           ('fsaf', 'FSAF'), ('fovea', 'FoveaBox'),
           ('sabl_retina', 'SABLRetinaNet'), ('pisa_retina', 'PISARetinaNet'),
           ('sabl_faster', 'SABLFasterRCNN'),
           ('pisa_faster', 'PISAFasterRCNN'))},
}
# the rows whose RPN and box heads keep mmdet's init scale
MMDET_ROWS = ('cascade', 'fpn', 'double_head', 'dynamic', 'crpn_faster',
              'ga_retina', 'sabl_faster', 'pisa_faster')


def _row_configs(name):
    """The row's config as the port's command line reads it, and the same
    file with the same --cfg-options in the JAX package's reader."""
    argv = runs.row_argv(name, 'unused')
    port = ttools_train.load_config(ttools_train.parse_args(argv))
    options = argv[argv.index('--cfg-options') + 1:]
    jax_cfg = jconfig.Config.fromfile(str(ROOT / argv[0]))
    jax_cfg.merge_from_dict({
        kv.split('=', 1)[0]: tconfig.parse_option_value(kv.split('=', 1)[1])
        for kv in options})
    return port, jax_cfg


def _images(ds_cfg):
    """(domain directory, split, image count) of a dataset config, read by
    the port's dataset builder."""
    ds = tdata.build_dataset(dict(ds_cfg, test_mode=False), 'cpu')
    domain = pathlib.PurePath(ds_cfg['img_prefix']).name
    split = pathlib.PurePath(ds_cfg['ann_file']).stem
    return domain, split, len(ds)


@pytest.mark.parametrize('name', sorted(TABLE))
def test_row_reads_the_committed_set_and_builds_what_jax_builds(name):
    trains_on, evaluates_on, model_type, epochs, steps = TABLE[name]
    port, jax_cfg = _row_configs(name)
    paths = [ds[f] for _, ds in runs._datasets(port.data)
             for f in ('ann_file', 'img_prefix')]
    assert paths and all(p.startswith(f'{SYNTH_DA}/') for p in paths), paths
    train = port.data['train']
    subs = train['datasets'] if train.get('type') == 'ConcatDataset' \
        else [train]
    assert [_images(s) for s in subs] == [(d, 'train', 200)
                                          for d in trains_on]
    # the loop evaluates `data.val`; the zoo config leaves `data.test`
    # (`tools.test`'s) on its base's foggy split
    assert _images(port.data['val']) == (evaluates_on, 'test', 50)
    assert _images(port.data['test'])[1:] == ('test', 50)
    row = runs.ROWS[name]
    assert (row.trains_on, row.evaluates_on) == (
        tuple((d, 'train') for d in trains_on), evaluates_on)
    for cfg in (port, jax_cfg):
        assert cfg.model['type'] == model_type
        assert cfg.runner['max_epochs'] == epochs
        assert list(cfg.lr_config['step']) == steps
        assert cfg.evaluation['interval'] == 5
    for key in ('optimizer', 'optimizer_config', 'lr_config', 'runner',
                'ema', 'evaluation'):
        assert port.get(key) == jax_cfg.get(key), key
    assert port.data == jax_cfg.data
    assert port.model == jax_cfg.model


def _subset(root):
    """A copy of the committed small set's layout whose lists name 8
    training and 4 test images a domain (the images and annotations are
    links to the committed ones)."""
    for domain in ('shapes_clear', 'shapes_foggy'):
        d = root / domain
        (d / 'ImageSets/Main').mkdir(parents=True)
        for sub in ('JPEGImages', 'Annotations'):
            (d / sub).symlink_to(SMALL / domain / sub)
        for split, n in (('train', 8), ('test', 4)):
            names = (SMALL / domain / f'ImageSets/Main/{split}.txt'
                     ).read_text().split()[:n]
            (d / f'ImageSets/Main/{split}.txt').write_text(
                '\n'.join(names) + '\n')
    return str(root)


# the daf row narrowed for the CPU (`NARROW`), few proposals and RoIs, 2 epochs with an evaluation after each
REHEARSAL = [*NARROW_OPTIONS,
             'model.train_cfg.rpn_proposal.nms_pre=256',
             'model.train_cfg.rpn_proposal.max_per_img=64',
             'model.train_cfg.rcnn.sampler.num=32',
             'model.test_cfg.rpn.nms_pre=256',
             'model.test_cfg.rpn.max_per_img=64',
             'runner.max_epochs=2', 'evaluation.interval=1']


def test_rehearsal_stop_and_resume_give_the_records_of_one_run(tmp_path):
    """`--device cpu`: the daf row for 2 epochs of 2 steps (4 + 4 images)
    with an evaluation after each; and the same stopped after epoch 1
    (`--max-epochs 1`: one epoch and an evaluation, `ckpt_1` kept) and
    resumed from `ckpt_1`: the log records, the AP50s and each epoch's
    loss means are those of the run without a stop, and a row that
    reaches its end empties its run directory."""
    data = _subset(tmp_path / 'data')
    common = ['--device', 'cpu', '--data-dir', data, '--cfg-options',
              *REHEARSAL]
    (whole,) = runs.main(['daf', '--work-dir', str(tmp_path / 'whole'),
                          *common])
    assert whole['steps_per_epoch'] == 2 and whole['epochs'] == [1, 2]
    assert not (tmp_path / 'whole/daf').exists()
    assert json.loads((tmp_path / 'whole/daf.json').read_text())[
        'records'] == whole['records']

    work = tmp_path / 'split'
    (first,) = runs.main(['daf', '--work-dir', str(work), '--max-epochs',
                          '1', *common])
    assert first['split'] == dict(resumed_from=None, stopped_after=1)
    assert first['epochs'] == [1, 1] and first['final_ap50'] is None
    assert [r['mode'] for r in first['records']] == ['train', 'val']
    assert (work / 'daf/ckpt_1').is_dir()
    ckpt = str(work / 'daf/ckpt_1')
    (second,) = runs.main(['daf', '--work-dir', str(work), '--resume-from',
                           ckpt, *common])
    assert second['split'] == dict(resumed_from=ckpt, stopped_after=None)
    assert second['epochs'] == [2, 2]
    assert second['records'] == whole['records']
    assert second['ap50'] == whole['ap50'] and len(whole['ap50']) == 2
    assert second['final_ap50'] == whole['final_ap50'] is not None
    assert {**first['loss_epoch_means'], **second['loss_epoch_means']} == \
        whole['loss_epoch_means']
    assert not (work / 'daf').exists()


def test_lecun_head_scale_is_an_option_the_da_rows_take():
    """`random_init.heads=lecun` leaves the RPN convs and the box head's
    classifier and regressor at the lecun scale (std 1/sqrt(fan_in)), as
    the JAX package draws them; the default redraws them at mmdet's
    (0.01, 0.01, 0.001); every other tensor is the same draw. The DA rows,
    Grid R-CNN, GA-Faster R-CNN and the one-stage rows ask for it, the
    other zoo rows (`MMDET_ROWS`) do not, and another value raises."""
    ttrain = importlib.import_module(f'{PORT_PKG}.apis.train')
    tiny = str(ROOT / 'configs/da/faster_rcnn_r18_tiny_fixture.py')
    models = {}
    for heads in ('mmdet', 'lecun'):
        cfg = tconfig.Config.fromfile(tiny)
        cfg.merge_from_dict({'random_init.heads': heads})
        models[heads] = ttrain.init_trainer(cfg, device='cpu',
                                            steps_per_epoch=1).model
    heads = {'rpn_head.rpn_conv.weight': 0.01, 'rpn_head.rpn_cls.weight':
             0.01, 'rpn_head.rpn_reg.weight': 0.01,
             'bbox_head.fc_cls.weight': 0.01, 'bbox_head.fc_reg.weight': 1e-3}
    mmdet = dict(models['mmdet'].state_dict())
    for n, t in models['lecun'].state_dict().items():
        if n not in heads:
            assert torch.equal(t, mmdet[n]), n
            continue
        fan_in = t[0].numel()
        assert abs(float(t.std()) * fan_in ** 0.5 - 1) < 0.1, n
        assert abs(float(mmdet[n].std()) / heads[n] - 1) < 0.1, n
    for name, row in runs.ROWS.items():
        assert (row.options.get('random_init.heads') == 'lecun') == \
            (name not in MMDET_ROWS), name
    cfg = tconfig.Config.fromfile(tiny)
    cfg.merge_from_dict({'random_init.heads': 'xavier'})
    with pytest.raises(ValueError, match='random_init.heads'):
        ttrain.init_trainer(cfg, device='cpu', steps_per_epoch=1)


@pytest.mark.parametrize('config', ['configs/da/synth_maskscoring_smoke.py',
                                    'configs/da/synth_pointrend_smoke.py'])
def test_coco_mask_runs_lists_the_mask_variant_rows(config):
    """`tools/coco_mask_runs.py synth --config` takes the Mask Scoring
    R-CNN and PointRend rows: each parses, redirected to the committed
    polygon split as `run_synth` redirects it, into the model the JAX
    reader reads (R18, 2 classes) and builds the port's type, with the
    split's 200 training and 50 test images."""
    mask_runs = importlib.import_module(f'{PORT_PKG}.tools.coco_mask_runs')
    tbuilder = importlib.import_module(f'{PORT_PKG}.models.builder')
    assert config in mask_runs.SYNTH_CONFIGS
    seg = mask_runs.SEG_DIR
    options = mask_runs.split_options({'data.train': f'{seg}/train.json',
                                       'data.val': f'{seg}/test.json',
                                       'data.test': f'{seg}/test.json'})
    port = tconfig.Config.fromfile(str(ROOT / config))
    port.merge_from_dict(options)
    jax_cfg = jconfig.Config.fromfile(str(ROOT / config))
    assert port.model == jax_cfg.model
    kind = pathlib.Path(config).stem.split('_')[1]
    model = tbuilder.build_detector(port.model, device='meta')
    assert type(model).__name__ == {'maskscoring': 'MaskScoringRCNN',
                                    'pointrend': 'PointRend'}[kind]
    assert model.num_classes == 2 and len(model.backbone.layer3) == 2
    with_root = {k: str(ROOT / v) for k, v in options.items()}
    for split, n in (('train', 200), ('val', 50)):
        ds = dict(port.data[split], **{
            f: with_root[f'data.{split}.{f}'] for f in ('ann_file',
                                                        'img_prefix')})
        assert len(tdata.build_dataset(dict(ds, test_mode=split != 'train'),
                                       'cpu')) == n
