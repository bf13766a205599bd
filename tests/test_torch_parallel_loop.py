"""Multi-rank training of the port on gloo ranks on the CPU, the parts
below the step and above it:

- each module that couples rows, on a batch whose ranks' counts differ
  (`torch_parallel_workers.py:global_batch_cases`): the loss shares of 2
  ranks sum to the one-process loss (1e-5 relative), the input gradients'
  rows and the summed parameter gradients match (1e-5 of scale, floor
  1e-6), and BatchNorm's running statistics agree with one process
  (1e-6) and are bit-identical on both ranks;
- the samplers' and dropout's draws: a rank's rows of the global draw,
  exactly;
- the Megatron split: shards of parameters, momentum and EMA, and the
  gathered checkpoint payload, equal to the one-device ones exactly;
- the loader: a rank's rows equal its rows of the one-process batch,
  exactly;
- `train_detector(n_devices=2, device='cpu')` for 2 epochs on the
  committed synth subset (4 + 4 train and 4 val images of
  `tests/data/synth_da_small/`, the tiny fixture model): its records equal
  a one-process run's on the global batch (train losses 1e-4 relative,
  the val records exactly), its checkpoint loads and serves on one
  process, and a resume from its first checkpoint ends bit-exact on the
  uninterrupted run's;
- two processes of `tools.DA_train --launcher jax` with a `dist_params`
  block and a `mesh` block of model=2 (the counterpart of the JAX
  `test_init_multihost_two_processes`): their records equal the
  one-process run's (1e-4 relative).

Ranks run under a time limit after which every rank is killed and the
test fails.
"""

import importlib
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from . import torch_parallel_workers as workers
from .torch_port_utils import NARROW, NARROW_OPTIONS, PORT_PKG, SYNTH_DATA

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = str(ROOT / 'configs/da/faster_rcnn_r18_tiny_fixture.py')
LIMIT_S = 240

ttrain = importlib.import_module(f'{PORT_PKG}.apis.train')
tinference = importlib.import_module(f'{PORT_PKG}.apis.inference')
tconfig = importlib.import_module(f'{PORT_PKG}.utils.config')
tckpt = importlib.import_module(f'{PORT_PKG}.utils.checkpoint')
tdata = importlib.import_module(f'{PORT_PKG}.data')
multihost = importlib.import_module(f'{PORT_PKG}.parallel.multihost')


def _ranks(fn, n, *args):
    return multihost.run_ranks(fn, n, args, threads=1, timeout_s=LIMIT_S)


def _close_scaled(got, ref, tol, floor=1.0, name=''):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    scale = max(floor, float(np.abs(ref).max())) if ref.size else 1.0
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    assert err <= tol * scale, f'{name}: {err:.3e} > {tol} x {scale:.3e}'


def _rel(got, ref, tol):
    assert abs(got - ref) <= tol * max(abs(ref), 1e-6), (got, ref)


# ---- the modules that couple rows -----------------------------------------

CASES = ['batch_norm', 'grouped_instance_loss', 'split_plain', 'rpn_loss',
         'bbox_loss', 'mask_loss', 'consistency_loss',
         'global_alignment_loss', 'gan_losses',
         *workers.ONE_STAGE_CASES, *workers.ANCHOR_HEAD_CASES]


@pytest.fixture(scope='module')
def cases():
    ref = workers.cases_and_draws(CASES)
    ranks = _ranks(workers.cases_and_draws, 2, CASES)
    return (ref['cases'], [r['cases'] for r in ranks], ref['draws'],
            [r['draws'] for r in ranks])
@pytest.mark.parametrize('name', CASES)
def test_module_on_two_ranks_computes_the_global_batch(cases, name):
    ref, ranks = cases[0][name], [r[name] for r in cases[1]]
    _rel(sum(float(r['loss']) for r in ranks), float(ref['loss']), 1e-5)
    for k, g in ref['grads'].items():
        g = g.numpy()
        if k.startswith('param.'):
            got = sum(r['grads'][k] for r in ranks)
        else:
            got = np.concatenate([r['grads'][k] for r in ranks])
        _close_scaled(got, g, 1e-5, floor=1e-6, name=k)
    for k, v in ref.get('buffers', {}).items():
        for r in ranks:
            _close_scaled(r['buffers'][k], v.numpy(), 1e-6, name=k)
            np.testing.assert_array_equal(r['buffers'][k],
                                          ranks[0]['buffers'][k])


@pytest.mark.parametrize('key', ['pos_mask', 'drop4d', 'drop2d'])
def test_draws_of_batch_shape_are_the_ranks_rows_of_the_global_draw(cases,
                                                                    key):
    _, _, ref, ranks = cases
    got = np.concatenate([r[key] for r in ranks])
    np.testing.assert_array_equal(got, ref[key].numpy())
    if key == 'pos_mask':
        assert got.any()
    else:                # dropout at 0.5 of ones: 0 or 2, both present
        assert set(np.unique(got)) == {0.0, 2.0}


# ---- the Megatron split ---------------------------------------------------

def test_tp_shards_follow_their_parameters_and_gather_whole(loop):
    """A checkpoint of the 2-rank run, restored and split over a model
    axis of 2 ranks as a resumed run restores it: each split parameter,
    its momentum and its EMA hold the rank's chunk of the checkpoint's
    tensor (fc1 by output rows, fc2 by input columns, torch layout); the
    other tensors stay whole; the optimizer's clip and the head know the
    split; the payload gathered back equals the checkpoint bit for
    bit."""
    out = _ranks(workers.tp_shards, 2, str(loop['two'] / 'ckpt_1'))
    for r in out:
        assert r['names'] == ['bbox_head.shared_fc1.bias',
                              'bbox_head.shared_fc1.weight',
                              'bbox_head.shared_fc2.weight']
        assert r['model_split'] == r['names'] and r['head_group']
        assert all(r['chunks_ok'].values()) and r['whole_ok']
        assert r['restored_bad'] == []
        assert r['restored_step'] == r['saved_step'] == 2


# ---- the loader -----------------------------------------------------------

def test_a_ranks_loader_rows_are_its_rows_of_the_one_process_batch():
    cfg = tconfig.Config.fromfile(TINY)
    cfg.merge_from_dict(_synth_paths(ROOT / SYNTH_DATA))
    ds = tdata.build_dataset(cfg.data['train'], 'cpu')
    full = list(tdata.DataLoader(ds, 4, seed=3, prefetch=0))
    for lo, hi in ((0, 2), (2, 4)):
        part = list(tdata.DataLoader(tdata.build_dataset(
            cfg.data['train'], 'cpu'), 4, seed=3, prefetch=0,
            rows=(lo, hi)))
        assert len(part) == len(full)
        for p, f in zip(part, full):
            assert set(p) == set(f)
            for k in f:
                assert torch.equal(p[k], f[k][lo:hi]), k


# ---- the loop on two ranks ------------------------------------------------

def _synth_paths(root, lists=None):
    """Overrides that point the tiny config at the synth subset (its
    classes), with the image lists `lists` (dir → file) when given."""
    out = {}
    cls = ('square', 'circle')
    for key, sub, split in (('data.train.datasets.0', 'shapes_clear', 'train'),
                            ('data.train.datasets.1', 'shapes_foggy', 'train'),
                            ('data.val', 'shapes_foggy', 'test'),
                            ('data.test', 'shapes_foggy', 'test')):
        base = f'{root}/{sub}/'
        out[f'{key}.ann_file'] = str((lists or {}).get(
            (sub, split), f'{base}ImageSets/Main/{split}.txt'))
        out[f'{key}.img_prefix'] = base
        out[f'{key}.classes'] = cls
    return out


def _loop_cfg(tmp, samples_per_gpu):
    """The tiny fixture model on 4 + 4 train and 4 val synth images, 2
    epochs of 2 global steps of 4 images, EMA, evaluation and checkpoints
    every epoch."""
    lists = {}
    for sub, split in (('shapes_clear', 'train'), ('shapes_foggy', 'train'),
                       ('shapes_foggy', 'test')):
        src = ROOT / SYNTH_DATA / sub / 'ImageSets/Main' / f'{split}.txt'
        dst = tmp / f'{sub}_{split}.txt'
        dst.write_text('\n'.join(src.read_text().split()[:4]) + '\n')
        lists[(sub, split)] = dst
    cfg = tconfig.Config.fromfile(TINY)
    cfg.merge_from_dict(_synth_paths(ROOT / SYNTH_DATA, lists))
    cfg.merge_from_dict({'data.samples_per_gpu': samples_per_gpu,
                         'ema': dict(momentum=0.9995),
                         'checkpoint_config': dict(interval=1)})
    return cfg


def _records(wd):
    return [json.loads(line) for line in open(wd / 'train_log.jsonl')]


@pytest.fixture(scope='module')
def loop(tmp_path_factory):
    """The runs, on 2 torch threads (1 a rank of `n_devices=2`): beside
    the suite's other workers more threads only contend. Their five
    checkpoints (3.4 GB) go when the module's tests are done."""
    tmp = tmp_path_factory.mktemp('ploop')
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        runs = _loop_runs(tmp)
    finally:
        torch.set_num_threads(prev)
    yield runs
    shutil.rmtree(tmp)


def _loop_runs(tmp):
    one, two, res = tmp / 'one', tmp / 'two', tmp / 'resumed'
    cfg1 = _loop_cfg(tmp, 4)
    cfg1.merge_from_dict({'checkpoint_config': dict(interval=2)})
    ttrain.train_detector(cfg1, str(one), device='cpu', log_interval=1)
    cfg2 = _loop_cfg(tmp, 2)
    metrics = ttrain.train_detector(cfg2, str(two), device='cpu',
                                    log_interval=1, n_devices=2)
    ttrain.train_detector(cfg2, str(res), device='cpu', log_interval=1,
                          n_devices=2, resume_from=str(two / 'ckpt_1'))
    ttrain.train_detector(_loop_cfg(tmp, 4), str(tmp / 'resumed_one'),
                          device='cpu', log_interval=1,
                          resume_from=str(two / 'ckpt_1'))
    return dict(one=one, two=two, res=res, res_one=tmp / 'resumed_one',
                cfg=cfg2, metrics=metrics)


def test_two_rank_run_writes_the_one_process_records(loop):
    one, two = _records(loop['one']), _records(loop['two'])
    assert [(r['mode'], r.get('epoch'), r.get('iter')) for r in two] == \
        [(r['mode'], r.get('epoch'), r.get('iter')) for r in one]
    assert [r['mode'] for r in two].count('train') == 4
    for a, b in zip(one, two):
        assert set(a) == set(b)
        if a['mode'] == 'val':
            assert a == b
            continue
        for k, v in a.items():
            if isinstance(v, float):
                _rel(b[k], v, 1e-4)
    val = [r for r in two if r['mode'] == 'val'][-1]
    assert loop['metrics'] == {k: v for k, v in val.items()
                               if k not in ('mode', 'epoch')}


def test_two_rank_checkpoint_loads_and_serves_on_one_process(loop):
    ckpt = loop['two'] / 'ckpt_2'
    payload = tckpt.load_checkpoint(str(ckpt), 'cpu')
    ref = tckpt.load_checkpoint(str(loop['one'] / 'ckpt_2'), 'cpu')
    assert payload['step'] == ref['step'] == 4
    for key in ('params', 'momentum', 'ema_params', 'buffers'):
        assert {k: v.shape for k, v in payload[key].items()} == \
            {k: v.shape for k, v in ref[key].items()}, key
    bundle = tinference.init_detector(loop['cfg'], device='cpu',
                                      checkpoint=str(ckpt))
    assert bundle.classes == ('square', 'circle')
    img = ROOT / SYNTH_DATA / 'shapes_foggy/JPEGImages'
    paths = sorted(str(p) for p in img.iterdir())[:2]
    dets = tinference.inference_detector(bundle, paths)
    assert len(dets) == 2
    for per_image in dets:
        for cls_dets in per_image:
            assert np.isfinite(cls_dets).all()


def test_two_rank_resume_continues_as_one_process_resumes(loop):
    """A resume from the 2-rank run's first checkpoint, on 2 ranks, writes
    the records of a one-process resume from it (1e-4 relative), from
    epoch 2 on (the restored state itself is checked bit for bit in
    `test_tp_shards_follow_their_parameters_and_gather_whole`)."""
    got, ref = _records(loop['res']), _records(loop['res_one'])
    assert [(r['mode'], r['epoch']) for r in got] == \
        [('train', 2), ('train', 2), ('val', 2)]
    for a, b in zip(ref, got):
        assert set(a) == set(b)
        for k, v in a.items():
            if isinstance(v, float):
                _rel(b[k], v, 1e-4)
            else:
                assert b[k] == v
    assert tckpt.load_checkpoint(str(loop['res'] / 'ckpt_2'),
                                 'cpu')['step'] == 4


# ---- two processes through the CLI ----------------------------------------

def test_launcher_jax_with_dist_params_and_a_model_axis(tmp_path):
    """Two processes of `tools.DA_train --launcher jax`, joined by a
    `dist_params` block (a FileStore under tmp_path), on a mesh of one
    data rank and a model axis of two: the box head's pair is split over
    the processes, and the records equal one process's."""
    opts = ['runner.max_epochs=1', 'lr_config.warmup_iters=2',
            'log_config.interval=1', *NARROW_OPTIONS]
    ref_cfg = tconfig.Config.fromfile(TINY)
    ref_cfg.merge_from_dict(dict(NARROW, **{'runner.max_epochs': 1,
                                            'lr_config.warmup_iters': 2}))
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ttrain.train_detector(ref_cfg, str(tmp_path / 'one'), device='cpu',
                              log_interval=1)
    finally:
        torch.set_num_threads(prev)
    store = f'file://{tmp_path}/store'
    env = dict(os.environ, OMP_NUM_THREADS='1',
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + [p for p in os.environ.get(
                       'PYTHONPATH', '').split(os.pathsep) if p]))
    procs = [subprocess.Popen(
        [sys.executable, '-m', f'{PORT_PKG}.tools.DA_train', TINY,
         '--work-dir', str(tmp_path / 'two'), '--device', 'cpu',
         '--launcher', 'jax', '--cfg-options', *opts,
         f'dist_params.coordinator_address={store}',
         'dist_params.num_processes=2', f'dist_params.process_id={i}',
         'mesh.data=-1', 'mesh.model=2'],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=LIMIT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'process {i} failed:\n{out}'
    # the domain sizes and the work dir are printed once, by rank 0
    assert outs[0].count('[DA_train]') == 2 and '[DA_train]' not in outs[1]
    one, two = _records(tmp_path / 'one'), _records(tmp_path / 'two')
    assert [r['mode'] for r in two] == [r['mode'] for r in one] == \
        ['train'] * 3 + ['val']
    for i, (a, b) in enumerate(zip(one, two)):
        assert set(a) == set(b)
        for k, v in a.items():
            if not isinstance(v, float):
                assert b[k] == v
            elif i == 0:
                _rel(b[k], v, 1e-5)
            else:
                assert np.isfinite(b[k])
    payload = tckpt.load_checkpoint(str(tmp_path / 'two' / 'ckpt_1'), 'cpu')
    ref = tckpt.load_checkpoint(str(tmp_path / 'one' / 'ckpt_1'), 'cpu')
    w = 'bbox_head.shared_fc1.weight'
    assert payload['params'][w].shape == ref['params'][w].shape
