"""Multi-rank training of the port (`parallel/`) on gloo ranks on the CPU:
a step on N ranks computes the single-process step on the global batch,
as the JAX mesh step does.

- The tiny DAF step on a 2x2 (data, model) layout of 4 ranks against the
  JAX step on a 2x2 CPU mesh (the one JAX compile here), from the same
  weights and batch with the same sampler priorities and dropout off:
  losses within 1e-4 relative; parameters, BN statistics, EMA and
  momentum within 1e-4 of scale (max(1, |ref|)). Held tensor by tensor
  at its own scale (floor 1e-3), as `test_torch_train.py` holds the
  one-device step on its 2 images, the momentum of the trunk's C3 block
  (`layer2.1`, under the pixel head's live BatchNorm) is 3.4e-4 off on
  this 4-image batch, and exactly as far for the port's one-process step
  on the same batch: the rounding of that BatchNorm's backward, not the
  split over ranks.
- The FPN and CyDA programs of `parallel/dryrun.py` at dp = 2 against the
  port's one-process step on the global batch (dropout on: each rank draws
  its rows of the global mask): losses 1e-5 relative, state 1e-4 of scale.
  CyDA takes one step: in its second, a generator unit within rounding of
  zero turns a 1e-6 difference into a 1e-3 one (a limit of step parity,
  ROADMAP Queue 3).

The modules that couple rows, the Megatron split, the loader and the loop
on several ranks are in `test_torch_parallel_loop.py`.

Ranks run in spawned processes with a FileStore rendezvous in a fresh
temporary directory, one thread each, under a time limit after which
every rank is killed and the test fails.
"""

import importlib
import pathlib

import jax
import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import pytest

from .test_torch_train import _jax_fixed_samplers, _no_dropout, _tiny_cfg
from .torch_port_utils import JAX_PKG, PORT_PKG, fill_variables

jbuilder = importlib.import_module(f'{JAX_PKG}.models.builder')
jconfig = importlib.import_module(f'{JAX_PKG}.utils.config')
jts = importlib.import_module(f'{JAX_PKG}.apis.train_state')
jpar = importlib.import_module(f'{JAX_PKG}.parallel')
ttrain = importlib.import_module(f'{PORT_PKG}.apis.train')
convert = importlib.import_module(f'{PORT_PKG}.utils.convert')
dryrun = importlib.import_module(f'{PORT_PKG}.parallel.dryrun')
multihost = importlib.import_module(f'{PORT_PKG}.parallel.multihost')

ROOT = pathlib.Path(__file__).resolve().parent.parent
LIMIT_S = 240          # a rank past this fails its test


def _ranks(fn, n, *args):
    return multihost.run_ranks(fn, n, args, threads=1, timeout_s=LIMIT_S)


def _close_scaled(got, ref, tol=1e-4, floor=1.0, name=''):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    if not ref.size:
        return
    scale = max(floor, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f'{name}: {err:.3e} > {tol} x {scale:.3e}'


def _rel(got, ref, tol):
    assert abs(got - ref) <= tol * max(abs(ref), 1e-6), (got, ref)


# ---- the DAF step on a 2x2 layout against the JAX 2x2 mesh ----------------

@pytest.fixture(scope='module')
def mesh_steps():
    """Two steps on both sides at 128x192, 4 images (2 a data rank); the
    weights' seed is `test_torch_train.py`'s (no ReLU flips)."""
    cfg = _tiny_cfg()
    model = jbuilder.build_detector(jconfig.Config.fromfile(
        str(ROOT / dryrun.TINY_CONFIG)).model)
    batch = dryrun.demo_batch(4, 128, 192)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    k0 = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: model.init(
        {'params': k0, 'sampler': k0, 'dropout': k0}, jbatch, train=True))
    variables = fill_variables(shapes, np.random.RandomState(5))
    spec = jts.OptimizerSpec(**ttrain.optimizer_spec(cfg, 1)._asdict())
    jstate, tx = jts.create_train_state(model, variables, spec,
                                        frozen_stages=1, ema=True)
    rpn_key, roi_key = jax.random.PRNGKey(21), jax.random.PRNGKey(22)
    anchors = 8 * 12 * model.anchor_cfg.num_anchors
    cands = batch['gt_bboxes'].shape[1] + model.rpn_proposal_cfg.max_per_img
    pri = dict(
        rpn=np.broadcast_to(np.asarray(jax.random.uniform(
            rpn_key, (anchors,))), (4, anchors)).copy(),
        rcnn=np.broadcast_to(np.asarray(jax.random.uniform(
            roi_key, (cands,))), (4, cands)).copy())
    mesh = jpar.make_mesh(4, model=2)
    jmetrics = []
    with _jax_fixed_samplers(rpn_key, roi_key), \
            fnn.intercept_methods(_no_dropout), mesh:
        jstate = jpar.shard_train_state(jstate, mesh)
        sbatch = jpar.shard_batch(batch, mesh)
        step = jax.jit(jts.make_train_step(
            model, tx, skip_nonfinite=True, ema_momentum=0.9995))
        step = step.lower(jstate, sbatch, jax.random.PRNGKey(3)).compile(
            compiler_options={'xla_disable_hlo_passes': 'algsimp'})
        for _ in range(2):
            jstate, m = step(jstate, sbatch, jax.random.PRNGKey(3))
            jmetrics.append(jax.tree_util.tree_map(np.asarray, m))
    ranks = _ranks(dryrun.rank_steps, 4, cfg, batch, 2, 'cpu', 0, 2,
                   variables, pri, True)
    port_model = ttrain.init_trainer(cfg, variables=variables, device='cpu',
                                     steps_per_epoch=1).model
    return dict(jstate=jax.device_get(jstate), jmetrics=jmetrics,
                ranks=ranks, model=port_model)


def _converted(tree, model):
    state, unmapped = convert.from_jax_variables(tree, model)
    assert unmapped == []
    return {k: v.numpy() for k, v in state.items()}


def test_daf_step_on_a_2x2_layout_losses_match_the_jax_mesh(mesh_steps):
    for r in mesh_steps['ranks']:
        assert r['metrics'] == mesh_steps['ranks'][0]['metrics']
    for jm, tm in zip(mesh_steps['jmetrics'], mesh_steps['ranks'][0][
            'metrics']):
        assert set(tm) == set(jm)
        for k in jm:
            assert np.isfinite(tm[k])
            _rel(tm[k], float(jm[k]), 1e-4)
        assert tm['skipped_nonfinite'] == 0


def test_daf_step_on_a_2x2_layout_state_matches_the_jax_mesh(mesh_steps):
    """The gathered one-device payload of rank 0: parameters, DA-head BN
    statistics, EMA and momentum within 1e-4 of scale."""
    jstate, model = mesh_steps['jstate'], mesh_steps['model']
    got = mesh_steps['ranks'][0]['payload']
    ref = _converted({'params': jstate.params,
                      'batch_stats': jstate.batch_stats}, model)
    assert got['step'] == 2
    for key in ('params', 'buffers'):
        for k, v in got[key].items():
            _close_scaled(v, ref[k], name=k)
    mom = _converted({'params': jstate.opt_state.momentum}, model)
    for k, m in got['momentum'].items():
        _close_scaled(m, mom[k], name=k)
    ema = _converted({'params': jstate.ema_params}, model)
    for k, e in got['ema_params'].items():
        _close_scaled(e, ema[k], name=k)
    # the split pair came back whole
    w1 = got['params']['bbox_head.shared_fc1.weight']
    assert w1.shape == tuple(
        model.bbox_head.shared_fc1.weight.shape)


# ---- FPN and CyDA at dp = 2 against one process ---------------------------

@pytest.mark.parametrize('program,steps', [('fpn', 2), ('cyda', 1)])
def test_program_at_dp2_matches_the_one_process_step(program, steps):
    cfg = dryrun.program_config(program)
    batch = dryrun.demo_batch(4)
    ref = dryrun.rank_steps(cfg, batch, steps)
    got = _ranks(dryrun.rank_steps, 2, cfg, batch, steps)
    assert got[0]['metrics'] == got[1]['metrics']
    for rm, gm in zip(ref['metrics'], got[0]['metrics']):
        assert set(rm) == set(gm)
        for k in rm:
            _rel(gm[k], rm[k], 1e-5)
    for key in ('params', 'buffers', 'momentum'):
        for k, v in ref['payload'][key].items():
            _close_scaled(got[0]['payload'][key][k], v.numpy(), name=k)
