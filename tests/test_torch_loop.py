"""The port's train → evaluate → checkpoint → resume → serve loop on the
CPU: two epochs of `tools.DA_train` on the tiny fixture config (its RPN
and box head narrowed, `NARROW`), resume from its first checkpoint,
`init_detector(checkpoint=...)`, `load_from`, the iteration-based runner,
and the options the single-device loop refuses.
The log records are held to the JAX package's format: the keys its loop
writes (`mode`, `epoch`, `iter` and its train step's metrics, which
`jax.eval_shape` of that step gives without compiling it)."""

import importlib
import json
import os
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .torch_port_utils import JAX_PKG, NARROW, NARROW_OPTIONS, PORT_PKG

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = str(ROOT / 'configs/da/faster_rcnn_r18_tiny_fixture.py')

jbuilder = importlib.import_module(f'{JAX_PKG}.models.builder')
jconfig = importlib.import_module(f'{JAX_PKG}.utils.config')
jts = importlib.import_module(f'{JAX_PKG}.apis.train_state')
ttrain = importlib.import_module(f'{PORT_PKG}.apis.train')
tinference = importlib.import_module(f'{PORT_PKG}.apis.inference')
tconfig = importlib.import_module(f'{PORT_PKG}.utils.config')
ckpt_io = importlib.import_module(f'{PORT_PKG}.utils.checkpoint')
da_train = importlib.import_module(f'{PORT_PKG}.tools.DA_train')
ttools_test = importlib.import_module(f'{PORT_PKG}.tools.test')
tdata = importlib.import_module(f'{PORT_PKG}.data')


def _paths():
    """--cfg-options that make the tiny config's data paths absolute."""
    out = []
    for key, sub in (('data.train.datasets.0', 'voc_source'),
                     ('data.train.datasets.1', 'voc_target'),
                     ('data.val', 'voc_target'), ('data.test', 'voc_target')):
        split = 'train' if 'train' in key else 'test'
        out += [f'{key}.ann_file={ROOT}/tests/data/{sub}/ImageSets/Main/'
                f'{split}.txt', f'{key}.img_prefix={ROOT}/tests/data/{sub}/']
    return out


def _argv(work_dir, *extra):
    """The CLI's arguments on the tiny config, narrowed (`NARROW`), with
    the EMA of the gate-3 config (the tiny one keeps none)."""
    return [TINY, '--work-dir', str(work_dir), '--device', 'cpu',
            '--cfg-options', *_paths(), *NARROW_OPTIONS,
            'ema.momentum=0.9995', *extra]


def _snapshot(d):
    return {k: ({n: t.detach().clone() for n, t in v.items()}
                if isinstance(v, dict) else v) for k, v in d.items()}


def _equal_payload(got, ref):
    for key in ('step', 'opt_count'):
        assert got[key] == ref[key], key
    for key in ('params', 'buffers', 'momentum', 'ema_params'):
        assert set(got[key]) == set(ref[key]), key
        for n, v in ref[key].items():
            assert torch.equal(got[key][n], v), f'{key}.{n}'


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """Two epochs of the CLI, then a resume from ckpt_1. A spy on the
    evaluation records the parameters it sees and the detections of the
    evaluated model on one batch; one on the restore records the state it
    restored; one on each step records the step and the state of the
    samplers' generator it was given."""
    wd = tmp_path_factory.mktemp('loop')
    evals, restored, draws = [], [], []
    orig_eval, orig_restore, orig_init = ttrain.evaluate_dataset, \
        ttrain.restore_train_state, ttrain.init_trainer
    probe = next(iter(tdata.DataLoader(
        tdata.build_dataset(tconfig.Config.fromfile(TINY).data['test'] | dict(
            ann_file=f'{ROOT}/tests/data/voc_target/ImageSets/Main/test.txt',
            img_prefix=f'{ROOT}/tests/data/voc_target/', test_mode=True),
            'cpu'),
        2, shuffle=False, two_stream=False, drop_last=False)))

    def eval_spy(model, dataset, samples_per_batch=2, metric='mAP',
                 **kwargs):
        with torch.no_grad():
            pred = {k: v.clone() for k, v in model.predict(probe).items()}
        evals.append(dict(
            params={n: p.detach().clone()
                    for n, p in model.named_parameters()},
            training=model.training, pred=pred))
        return orig_eval(model, dataset, samples_per_batch, metric, **kwargs)

    def restore_spy(model, state, ckpt):
        state = orig_restore(model, state, ckpt)
        restored.append(_snapshot(ckpt_io.train_state_dict(model, state)))
        return state

    def init_spy(*a, **k):
        trainer = orig_init(*a, **k)

        def step(state, batch, generator=None, **kw):
            draws.append((state.step, generator.get_state().clone(),
                          torch.get_rng_state()))
            return trainer.step(state, batch, generator, **kw)
        return trainer._replace(step=step)

    ttrain.evaluate_dataset = eval_spy
    ttrain.restore_train_state = restore_spy
    ttrain.init_trainer = init_spy
    try:
        metrics = da_train.main(_argv(wd))
        first = [json.loads(line)
                 for line in open(wd / 'train_log.jsonl')]
        saved = {e: ckpt_io.load_checkpoint(str(wd / f'ckpt_{e}'))
                 for e in (1, 2)}
        resumed = da_train.main(_argv(wd, '--resume-from',
                                      str(wd / 'ckpt_1')))
    finally:
        ttrain.evaluate_dataset = orig_eval
        ttrain.restore_train_state = orig_restore
        ttrain.init_trainer = orig_init
    log = [json.loads(line) for line in open(wd / 'train_log.jsonl')]
    yield dict(wd=wd, metrics=metrics, first=first, log=log, saved=saved,
               evals=evals, restored=restored, resumed=resumed,
               probe=probe, draws=draws)
    shutil.rmtree(wd)           # its checkpoints, when the module is done


def _jax_metric_keys():
    """The metrics of the JAX package's train step on the tiny config (the
    NaN guard on, as for DAFasterRCNN), from `jax.eval_shape`."""
    cfg = jconfig.Config.fromfile(TINY)
    model = jbuilder.build_detector(cfg.model)
    b, (h, w) = 2, cfg.canvas
    batch = dict(image=jnp.zeros((b, h, w, 3)),
                 img_shape=jnp.full((b, 2), h, jnp.int32),
                 gt_bboxes=jnp.zeros((b, 4, 4)),
                 gt_labels=jnp.zeros((b, 4), jnp.int32),
                 gt_valid=jnp.ones((b, 4), bool),
                 domain=jnp.array([0, 1], jnp.int32))
    k = jax.random.PRNGKey(0)

    def step():
        variables = model.init({'params': k, 'sampler': k, 'dropout': k},
                               batch, train=True)
        state, tx = jts.create_train_state(model, variables,
                                           jts.OptimizerSpec(),
                                           frozen_stages=1)
        return jts.make_train_step(model, tx, skip_nonfinite=True)(
            state, batch, k)[1]
    return set(jax.eval_shape(step))


def test_log_records_have_the_jax_format(run):
    train = [r for r in run['first'] if r['mode'] == 'train']
    val = [r for r in run['first'] if r['mode'] == 'val']
    assert [(r['epoch'], r['iter']) for r in train] == [(1, 3), (2, 3)]
    assert [r['epoch'] for r in val] == [1, 2]
    keys = {'mode', 'epoch', 'iter'} | _jax_metric_keys()
    for r in train:
        assert set(r) == keys
        assert all(np.isfinite(r[k]) for k in keys - {'mode'})
    for r in val:
        assert set(r) == {'mode', 'epoch', 'AP50', 'mAP'}
        assert 0.0 <= r['AP50'] <= 1.0
    assert run['metrics'] == {k: v for k, v in run['metrics'].items()}
    assert set(run['metrics']) == {'AP50', 'mAP'}


def test_checkpoints_and_their_meta(run):
    wd = run['wd']
    assert sorted(d for d in os.listdir(wd) if d.startswith('ckpt_')) == \
        ['ckpt_1', 'ckpt_2']
    for e in (1, 2):
        meta = ckpt_io.load_meta(str(wd / f'ckpt_{e}'))
        assert set(meta) == {'epoch', 'classes', 'loader'}
        assert dict(epoch=meta['epoch'], classes=meta['classes']) == \
            dict(epoch=e, classes=['car', 'person'])
        payload = run['saved'][e]
        assert payload['step'] == payload['opt_count'] == 3 * e
        assert payload['ema_params'] is not None
        assert set(payload['momentum']) < set(payload['params'])
        # the DA heads' BatchNorm statistics are among the buffers
        assert any('running' in n or n.endswith(('.mean', '.var'))
                   for n in payload['buffers'])
    assert ckpt_io.latest_checkpoint(str(wd)) == str(wd / 'ckpt_2')
    assert (wd / 'config.py').exists()


def test_eval_uses_the_ema_and_restores_the_live_params(run):
    """Each evaluation of the first run saw the EMA parameters of the
    checkpoint written just before it, in eval mode, and they differ from
    the live ones (which `_eval_weights` puts back, below)."""
    for e, seen in zip((1, 2), run['evals'][:2]):
        ema = run['saved'][e]['ema_params']
        assert not seen['training']
        assert all(torch.equal(seen['params'][n], ema[n]) for n in ema)
        assert any(not torch.equal(ema[n], run['saved'][e]['params'][n])
                   for n in ema)


def test_live_params_are_restored_bit_for_bit_after_eval():
    cfg = tconfig.Config.fromfile(TINY)
    cfg.merge_from_dict({'ema.momentum': 0.9995})
    trainer = ttrain.init_trainer(cfg, device='cpu', steps_per_epoch=1)
    state = trainer.state
    with torch.no_grad():
        for n, e in state.ema_params.items():
            e.add_(0.25)
    live = {n: p.detach().clone() for n, p in state.params.items()}
    with ttrain._eval_weights(trainer.model, state):
        assert not trainer.model.training
        assert all(torch.equal(p, state.ema_params[n])
                   for n, p in state.params.items())
    assert trainer.model.training
    assert all(torch.equal(p, live[n]) for n, p in state.params.items())


def test_resume_restores_every_tensor_and_starts_at_epoch_two(run):
    assert len(run['restored']) == 1
    _equal_payload(run['restored'][0], run['saved'][1])
    resumed = run['log'][len(run['first']):]
    assert [(r['mode'], r['epoch']) for r in resumed] == \
        [('train', 2), ('val', 2)]
    assert set(run['resumed']) == {'AP50', 'mAP'}


def test_resumed_steps_draw_what_the_uninterrupted_run_drew(run):
    """The samplers' generator is seeded from the step, as the JAX loop
    folds the step into its key: each step of the resumed epoch gets the
    generator state that the same step of the uninterrupted run got, and
    no two steps share one."""
    first, resumed = run['draws'][:6], run['draws'][6:]
    assert [s for s, *_ in first] == list(range(6))
    assert [s for s, *_ in resumed] == [3, 4, 5]
    for s, state, _ in resumed:
        assert torch.equal(state, first[s][1]), s
    assert all(not torch.equal(first[i][1], first[j][1])
               for i in range(6) for j in range(i))


def test_resumed_epoch_trains_on_the_uninterrupted_runs_batches(run):
    """ckpt_1 holds the loader's random state at the end of epoch 1 (the
    two-stream sampler's and each dataset's), so the resumed epoch 2 draws
    the batches the uninterrupted run drew: its records, losses and
    evaluation equal that run's epoch 2, and so do the saved states."""
    assert set(run['saved'][1]) >= {'params', 'momentum'}
    meta = ckpt_io.load_meta(str(run['wd'] / 'ckpt_1'))
    assert set(meta['loader']) == {'sampler', 'pools', 'datasets'}
    assert len(meta['loader']['datasets']) == 2
    resumed = run['log'][len(run['first']):]
    assert resumed == [r for r in run['first'] if r['epoch'] == 2]
    _equal_payload(ckpt_io.load_checkpoint(str(run['wd'] / 'ckpt_2')),
                   run['saved'][2])


def test_dropout_draws_follow_the_seed_and_the_step(run):
    """Dropout draws from torch's default generator, which torch seeds
    anew in each process; the loop seeds it at every step from the seed and
    the step, so every process, and a resumed run, draws the same masks (a
    run's detections would otherwise change from process to process)."""
    first, resumed = run['draws'][:6], run['draws'][6:]
    for s, _, state in first:
        torch.manual_seed(ttrain._dropout_seed(0, s))
        assert torch.equal(state, torch.get_rng_state()), s
    for s, _, state in resumed:
        assert torch.equal(state, first[s][2]), s
    assert all(not torch.equal(first[i][2], first[j][2])
               for i in range(6) for j in range(i))


def test_auto_resume_finds_the_latest(run, tmp_path):
    for e in (1, 2):
        os.symlink(run['wd'] / f'ckpt_{e}', tmp_path / f'ckpt_{e}')
    cfg = da_train.load_config(da_train.parse_args(_argv(tmp_path)))
    assert ckpt_io.latest_checkpoint(str(tmp_path)) == \
        str(tmp_path / 'ckpt_2')
    # resuming at the last epoch trains nothing more
    assert ttrain.train_detector(cfg, str(tmp_path), resume_from='auto',
                                 device='cpu') == {}
    assert not (tmp_path / 'ckpt_3').exists()


def test_init_detector_from_a_checkpoint_serves_the_ema_model(run):
    """`init_detector(checkpoint=ckpt_2)` gives the detections of the
    in-memory model with the EMA parameters, as the last evaluation (the
    resumed run's, which wrote ckpt_2 last) ran it; and its classes come
    from the checkpoint."""
    cfg = tconfig.Config.fromfile(TINY)
    cfg.merge_from_dict(NARROW)
    bundle = tinference.init_detector(cfg, device='cpu',
                                      checkpoint=str(run['wd'] / 'ckpt_2'))
    assert bundle.classes == ('car', 'person')
    ref = run['evals'][-1]['pred']
    with torch.no_grad():
        got = bundle.model.predict(run['probe'])
    assert set(got) == set(ref) and ref['valid'].any()
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


def test_tools_test_evaluates_a_checkpoint(run):
    metrics = ttools_test.main([TINY, str(run['wd'] / 'ckpt_2'), '--device',
                                'cpu', '--cfg-options', *_paths(),
                                *NARROW_OPTIONS])
    assert set(metrics) == {'AP50', 'mAP'}
    with pytest.raises(NotImplementedError, match='test-time'):
        ttools_test.main([TINY, str(run['wd'] / 'ckpt_2'), '--device', 'cpu',
                          '--flip-tta', '--cfg-options', *_paths(),
                          *NARROW_OPTIONS])


def test_load_from_loads_weights_and_no_optimizer_state(run, tmp_path,
                                                          monkeypatch):
    made = []
    orig = ttrain.init_trainer

    def capture(*a, **k):
        made.append(orig(*a, **k))
        return made[-1]
    monkeypatch.setattr(ttrain, 'init_trainer', capture)
    cfg = da_train.load_config(da_train.parse_args(
        _argv(tmp_path, 'runner.max_epochs=0')))
    ttrain.train_detector(cfg, str(tmp_path), device='cpu',
                          load_from=str(run['wd'] / 'ckpt_2'))
    state = made[0].state
    saved = ckpt_io.load_checkpoint(str(run['wd'] / 'ckpt_2'))
    assert state.step == 0 and state.opt_state.count == 0
    assert all(not m.any() for m in state.opt_state.momentum.values())
    for n, p in state.params.items():
        assert torch.equal(p, saved['params'][n])
        assert torch.equal(state.ema_params[n], p)
    buffers = dict(made[0].model.named_buffers())
    assert all(torch.equal(buffers[n], v)
               for n, v in saved['buffers'].items())


def test_pretrained_backbone_loads_the_trunk_before_training(tmp_path,
                                                            monkeypatch):
    """A torchvision ResNet checkpoint lands in the trunk (its BN
    statistics in the frozen BNs' buffers) before the first step, the EMA
    restarts from it, and the rest keeps its seeded weights."""
    from .test_torch_swin import _torchvision_r18_state_dict
    made = []
    orig = ttrain.init_trainer

    def capture(*a, **k):
        made.append(orig(*a, **k))
        seeded.update({n: t.clone() for n, t in
                       made[-1].model.state_dict().items()})
        return made[-1]
    seeded = {}
    monkeypatch.setattr(ttrain, 'init_trainer', capture)
    sd = _torchvision_r18_state_dict(np.random.RandomState(0))
    torch.save(sd, tmp_path / 'r18.pth')
    cfg = da_train.load_config(da_train.parse_args(
        _argv(tmp_path, 'runner.max_epochs=0')))
    ttrain.train_detector(cfg, str(tmp_path), device='cpu',
                          pretrained_backbone=str(tmp_path / 'r18.pth'))
    model, state = made[0].model, made[0].state
    got = model.state_dict()
    np.testing.assert_array_equal(
        got['backbone.trunk.layer1.0.conv1.weight'].numpy(),
        sd['layer1.0.conv1.weight'].numpy())
    np.testing.assert_array_equal(got['backbone.trunk.bn1.var'].numpy(),
                                  sd['bn1.running_var'].numpy())
    for n, t in got.items():
        assert torch.equal(t, seeded[n]) != n.startswith('backbone.trunk.'), n
    for n, p in state.params.items():
        assert torch.equal(state.ema_params[n], p)


def test_iteration_based_runner(tmp_path):
    """`IterBasedRunner`: steps count across epochs, checkpoints and evals
    at step intervals and at the end, records keyed by `iter`."""
    cfg = da_train.load_config(da_train.parse_args(_argv(
        tmp_path, 'checkpoint_config.interval=2', 'evaluation.interval=3')))
    cfg.merge_from_dict({'runner': dict(type='IterBasedRunner',
                                        max_iters=4)})
    ttrain.train_detector(cfg, str(tmp_path), device='cpu')
    assert sorted(d for d in os.listdir(tmp_path) if d.startswith('ckpt_')) \
        == ['ckpt_2', 'ckpt_4']
    val = [json.loads(line) for line in open(tmp_path / 'train_log.jsonl')
           if '"val"' in line]
    assert [r['iter'] for r in val] == [3, 4]


def test_max_epochs_overrides_the_runner_not_the_callers_config(tmp_path):
    cfg = da_train.load_config(da_train.parse_args(_argv(tmp_path)))
    ttrain.train_detector(cfg, str(tmp_path), device='cpu', max_epochs=1)
    assert sorted(d for d in os.listdir(tmp_path) if d.startswith('ckpt_')) \
        == ['ckpt_1']
    assert cfg.runner.max_epochs == 2


# the multi-device options (launcher, n_devices, mesh, dist_params) train:
# tests/test_torch_parallel_loop.py
@pytest.mark.parametrize('kwargs,cfg_over,match', [
    ({}, {'load_submodule': dict(teacher='x')}, 'load_submodule'),
    (dict(pretrained_backbone='pvt.pth'), {}, 'pretrained_backbone'),
    ({}, {'fp16': dict(loss_scale=512.0), 'model.dtype': 'float16'}, 'fp16'),
])
def test_refused_options_raise(tmp_path, kwargs, cfg_over, match):
    cfg = tconfig.Config.fromfile(TINY)
    cfg.merge_from_dict(cfg_over)
    if 'pretrained_backbone' in kwargs:
        # a checkpoint of a trunk the port does not have (PVT)
        path = tmp_path / kwargs['pretrained_backbone']
        torch.save({'patch_embed1.proj.weight': torch.zeros(2)}, path)
        kwargs = dict(kwargs, pretrained_backbone=str(path))
    with pytest.raises(NotImplementedError, match=match):
        ttrain.train_detector(cfg, str(tmp_path / 'wd'), device='cpu',
                              **kwargs)
    assert not (tmp_path / 'wd').exists()

