"""Whole bf16 paths of the port against the JAX package at
`dtype=jnp.bfloat16` on the CPU, and the config handling of the compute
type: one train step of the tiny DC5 DAF fixture and of a tiny Mask R-CNN
FPN, `predict` of a tiny FPN detector, one bf16 step of every other family
(the DA variants, C4, CyDA and CyCADA), the `fp16` gate (bf16 training, f32
serving), `--cfg-options model.dtype=bfloat16`, and float16's refusal.

The same numpy weights and batch go to both sides; the samplers' priorities
are fixed on both and dropout is off. The JAX steps compile with
`xla_disable_hlo_passes=algsimp`, as `tests/test_torch_train.py`'s do.

Tolerances, set by bf16's 2^-8 rounding: per-term losses within 2e-2
relative; the SGD update (parameters after the step minus before) within
5e-2 of its scale (`_update_held`); detections' boxes within 2e-2 of the
canvas and scores within 2e-2, labels and validity identical. Both sides
take the same proposals (`_fixed_proposals`), so the steps sample the
same RoIs.
"""

import contextlib
import importlib
import pathlib
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .test_torch_fpn import FPN_CFG, TINY, regression_init
from .test_torch_mask import C4_CFG, C4_TINY
from .test_torch_train import _demo_batch, _jax_fixed_samplers, _no_dropout
from .torch_port_utils import JAX_PKG, NARROW_OPTIONS, PORT_PKG, fill_variables

ROOT = pathlib.Path(__file__).resolve().parent.parent
DC5_TINY = str(ROOT / 'configs/da/faster_rcnn_r18_tiny_fixture.py')
MASK_FP16 = str(ROOT / 'configs/mask_rcnn/mask_rcnn_r50_fpn_fp16_1x.py')
FPN_FP16 = str(ROOT / 'configs/faster_rcnn/faster_rcnn_r50_fpn_fp16_1x.py')
BF16 = jnp.bfloat16
# one step at step count 0 with a warmup lr the update can show, and few
# proposals and samples
STEP = {'lr_config.warmup_ratio': 0.5,
        'model.rpn_proposal_cfg': dict(nms_pre=256, max_per_img=64),
        'model.roi_train_cfg': dict(num_samples=64)}
DC5_STEP = {'optimizer.lr': 0.002, 'lr_config.warmup_ratio': 0.5}

jts = importlib.import_module(f'{JAX_PKG}.apis.train_state')
jbuilder = importlib.import_module(f'{JAX_PKG}.models.builder')
jconfig = importlib.import_module(f'{JAX_PKG}.utils.config')
ttrain = importlib.import_module(f'{PORT_PKG}.apis.train')
tapis = importlib.import_module(f'{PORT_PKG}.apis.inference')
tconfig = importlib.import_module(f'{PORT_PKG}.utils.config')
tprofile = importlib.import_module(f'{PORT_PKG}.tools.profile_train')
tda_train = importlib.import_module(f'{PORT_PKG}.tools.DA_train')
tbuilder = importlib.import_module(f'{PORT_PKG}.models.builder')
trpn = importlib.import_module(f'{PORT_PKG}.models.dense_heads.rpn_head')
convert = importlib.import_module(f'{PORT_PKG}.utils.convert')


def _t(x):
    return torch.from_numpy(np.array(x))


def _converted(tree, model):
    state, unmapped = convert.from_jax_variables(tree, model)
    assert unmapped == []
    return state


def _port_cfg(path, overrides):
    cfg = tconfig.Config.fromfile(path)
    cfg.merge_from_dict(overrides)
    return cfg


def _jax_model(path, overrides):
    """The JAX detector of the config at bf16 (its builder drops a nested
    config's `dtype`, so the module is cloned at bf16)."""
    cfg = jconfig.Config.fromfile(path)
    cfg.merge_from_dict(overrides)
    return jbuilder.build_detector(cfg.model).clone(dtype=BF16)


PORT_DETECTORS = [importlib.import_module(
    f'{PORT_PKG}.models.detectors.{m}')
    for m in ('faster_rcnn', 'faster_rcnn_fpn', 'mask_rcnn_c4')]


@contextlib.contextmanager
def _fixed_proposals(jmodel, tmodel, batch, cfg):
    """Both sides' detectors take the port's own bf16 proposals of
    `batch` (at `cfg`) in place of computing theirs: the RPN logits of a
    random-weight detector sit an ulp apart or tie by the hundred in bf16,
    and the two sides' one-ulp differences would reorder them, so the
    steps would sample other RoIs."""
    with torch.no_grad():
        feats = tmodel.extract_feat(_t(batch['image']))
        fixed = trpn.rpn_proposals(*tmodel.rpn_outputs(feats),
                                   _t(batch['img_shape']), cfg)
    jmod = sys.modules[type(jmodel).__module__]
    saved = [(m, m.rpn_proposals) for m in [jmod] + PORT_DETECTORS]
    jmod.rpn_proposals = lambda *a, **k: tuple(
        jnp.asarray(x.numpy()) for x in fixed)
    for m in PORT_DETECTORS:
        m.rpn_proposals = lambda *a, **k: fixed
    try:
        yield fixed
    finally:
        for m, fn in saved:
            m.rpn_proposals = fn


def _paired_step(path, overrides, seed, port_overrides=None, mask=False,
                 fpn=False, regression=False):
    """One train step of the config's detector on both sides at bf16 from
    the same weights and batch (the 128x192 batch of `test_torch_train.py`,
    with 28x28 box-frame rasters for a mask detector), dropout off and the
    samplers' priorities fixed. The port's config is `overrides` plus
    `port_overrides` (default: `model.dtype=bfloat16`). `fpn`: anchors on
    the five FPN strides; `regression`: the regressors at mmdet's init
    scale (`regression_init`)."""
    model = _jax_model(path, overrides)
    cfg = _port_cfg(path, dict(overrides, **(
        port_overrides if port_overrides is not None
        else {'model.dtype': 'bfloat16'})))
    batch = _demo_batch()
    if mask:
        batch['gt_masks'] = tprofile.ellipse_masks(
            np.random.RandomState(6), batch['gt_valid'].shape, 28)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    k0 = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: model.init(
        {'params': k0, 'sampler': k0, 'dropout': k0}, jbatch, train=True))
    rs = np.random.RandomState(seed)
    variables = fill_variables(shapes, rs)
    if regression:
        variables = regression_init(variables, rs)
    trainer = ttrain.init_trainer(cfg, variables=variables, device='cpu',
                                  steps_per_epoch=1)
    spec = jts.OptimizerSpec(**trainer.spec._asdict())
    ema = trainer.state.ema_params is not None
    jstate, tx = jts.create_train_state(model, variables, spec,
                                        frozen_stages=1, ema=ema)
    ema_m = ttrain.ema_momentum_of(cfg)
    guard = cfg.model.get('type') in ttrain._ADVERSARIAL
    jstep = jax.jit(jts.make_train_step(model, tx, skip_nonfinite=guard,
                                        ema_momentum=ema_m))
    rpn_key, roi_key = jax.random.PRNGKey(21), jax.random.PRNGKey(22)
    h, w = batch['image'].shape[1:3]
    if fpn:
        anchors = 3 * sum(-(-h // s) * -(-w // s) for s in (4, 8, 16, 32,
                                                            64))
    else:
        anchors = (h // 16) * (w // 16) * model.anchor_cfg.num_anchors
    cands = batch['gt_bboxes'].shape[1] + model.rpn_proposal_cfg.max_per_img
    pri = dict(rpn=_t(jax.random.uniform(rpn_key, (anchors,))).expand(2, -1),
               rcnn=_t(jax.random.uniform(roi_key, (cands,))).expand(2, -1))
    for m in trainer.model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    start = {k: v.detach().clone() for k, v in trainer.state.params.items()}
    with _jax_fixed_samplers(rpn_key, roi_key), \
            fnn.intercept_methods(_no_dropout), \
            _fixed_proposals(model, trainer.model, batch,
                             trainer.model.rpn_proposal_cfg):
        jstep = jstep.lower(jstate, jbatch, jax.random.PRNGKey(3)).compile(
            compiler_options={'xla_disable_hlo_passes': 'algsimp'})
        jstate, jm = jstep(jstate, jbatch, jax.random.PRNGKey(3))
        state, tm = trainer.step(trainer.state, {k: _t(v) for k, v in
                                                 batch.items()},
                                 sampler_priorities=pri)
    return dict(jstate=jax.device_get(jstate), variables=variables,
                jmetrics={k: float(v) for k, v in jm.items()},
                tmetrics={k: float(v) for k, v in tm.items()},
                trainer=trainer, state=state, start=start)


def _losses_held(run, keys):
    jm, tm = run['jmetrics'], run['tmetrics']
    assert set(tm) == set(jm) and keys <= set(tm)
    for k, ref in jm.items():
        assert np.isfinite(tm[k]), k
        assert abs(tm[k] - ref) <= 2e-2 * abs(ref), (k, tm[k], ref)


def _update_held(run):
    """The SGD update (parameters after the step minus before) within 5e-2
    of its scale, the largest entry of the JAX side's update, tensor by
    tensor; the frozen tensors unchanged. Parameters, gradients, momentum
    and EMA f32. (The scale is the whole update's, not each tensor's: the
    DA global heads' updates differ by 30-60% of their own size between
    the JAX package's f32 and bf16 steps of the tiny DAF fixture, its
    BatchNorms averaging 12 values and one-ulp tap differences flipping
    ReLUs.)"""
    trainer, state = run['trainer'], run['state']
    model = trainer.model
    ref = _converted({'params': run['jstate'].params}, model)
    start = run['start']
    deltas = {k: ((p.detach() - start[k]).double().numpy(),
                  (ref[k] - start[k]).double().numpy())
              for k, p in state.params.items()}
    scale = max(np.abs(want).max() for _, want in deltas.values())
    for k, p in state.params.items():
        assert p.dtype == torch.float32, k
        assert p.grad is None or p.grad.dtype == torch.float32, k
        got, want = deltas[k]
        if not trainer.optimizer.trainable[k]:
            assert not got.any() and not want.any(), k
            continue
        assert np.abs(got - want).max() <= 5e-2 * scale, (
            k, np.abs(got - want).max(), scale)
    assert scale > 0
    assert all(m.dtype == torch.float32
               for m in state.opt_state.momentum.values())
    if state.ema_params is not None:
        assert all(e.dtype == torch.float32
                   for e in state.ema_params.values())


def test_dc5_daf_step_bf16():
    """The tiny fixture's DAF step (R18-DC5, CBAM global and pixel heads,
    grouped instance loss, grad clip, EMA) at bf16; the trunk answers in
    bf16, the DA heads in f32."""
    cfg = dict(DC5_STEP, **{'optimizer_config': dict(
        grad_clip=dict(max_norm=5.0)), 'ema': dict(momentum=0.9995)})
    run = _paired_step(DC5_TINY, cfg, 5)
    _losses_held(run, {'loss_rpn_cls', 'loss_rpn_bbox', 'loss_cls',
                       'loss_bbox', 'globle_da_loss', 'patch_bottom_loss',
                       'local_da_loss'})
    _update_held(run)
    model = run['trainer'].model
    assert model.backbone.trunk.conv1.compute_dtype == torch.bfloat16
    batch = {k: _t(v) for k, v in _demo_batch().items()}
    with torch.no_grad():
        (feat,), da_out = model.backbone(
            batch['image'].bfloat16().permute(0, 3, 1, 2))
    assert feat.dtype == torch.bfloat16
    assert set(da_out) and all(v.dtype == torch.float32
                               for v in da_out.values())


# ---- every other family: one bf16 step each ---------------------------------

FAMILIES = {
    'daf_org': (DC5_TINY, {'model.type': 'DAFasterRCNN_Org'}),
    'maf': (DC5_TINY, {'model.type': 'MAFasterRCNN'}),
    'swda': (DC5_TINY, {'model.type': 'FasterRCNN_SWDA'}),
    'deep': (DC5_TINY, {'model.type': 'DAFasterRCNN_Deep'}),
    'tri': (DC5_TINY, {'model.type': 'DAFasterRCNN_Tri'}),
    'cyda': (DC5_TINY, {'model.type': 'CyDAFasterRCNN',
                        'model.gen_blocks': 1}),
    'cycada': (DC5_TINY, {'model.type': 'CyCADA', 'model.gen_blocks': 1}),
    'c4': (C4_CFG, dict(C4_TINY, **STEP)),
}


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_family_builds_and_steps_in_bf16(name):
    """Each family builds at bf16 and takes one step on the tiny canvas
    with finite losses: the trunk, RPN and box head compute in bf16, the
    DA heads and the CycleGAN in f32, and parameters, gradients and
    momentum stay f32 (the DAF, FPN and Mask R-CNN steps are held to the
    JAX package in this file and in test_torch_bf16_fpn.py)."""
    path, overrides = FAMILIES[name]
    cfg = _port_cfg(path, dict(overrides, **{'model.dtype': 'bfloat16'}))
    trainer = ttrain.init_trainer(cfg, device='cpu', steps_per_epoch=1)
    model = trainer.model
    assert model.dtype == torch.bfloat16
    convs = {n: m.compute_dtype for n, m in model.named_modules()
             if hasattr(m, 'compute_dtype')}
    da = hasattr(model.backbone, 'trunk')
    trunk = 'backbone.trunk.' if da else 'backbone.'
    assert convs[trunk + 'conv1'] == convs['rpn_head.rpn_conv'] == \
        torch.bfloat16
    heads = [n for n in convs if n.startswith('backbone.')
             and not n.startswith(trunk) or n.startswith('local_da')]
    assert bool(heads) == (name != 'c4')
    assert all(convs[n] == torch.float32 for n in heads)
    gan = [m for n, m in model.named_modules() if n.startswith('gen_')
           and isinstance(m, torch.nn.Conv2d)]
    assert bool(gan) == (name in ('cyda', 'cycada'))
    assert not any(hasattr(m, 'compute_dtype') for m in gan)
    hw = (128, 192) if name == 'c4' else (64, 96)
    batch = tprofile.demo_batch(2, *hw, g=6, num_classes=2, seed=4,
                                device='cpu',
                                mask_size=14 if name == 'c4' else None)
    state, metrics = trainer.step(trainer.state, batch,
                                  torch.Generator().manual_seed(0))
    assert all(np.isfinite(float(v)) for v in metrics.values()), metrics
    assert not float(metrics.get('skipped_nonfinite', 0))
    opt = state.opt_state if name in ('cyda', 'cycada') \
        else (state.opt_state,)
    assert all(m.dtype == torch.float32 for o in opt
               for m in o.momentum.values())
    assert all(p.dtype == torch.float32 for p in state.params.values())


# ---- the compute type in configs ------------------------------------------

def test_fp16_block_trains_bf16_and_serves_f32():
    """An `fp16` block with no `model.dtype` trains in bf16 (loss_scale
    ignored) and serves in f32, as the JAX package's gate; a `model.dtype`
    wins over the block."""
    over = dict(TINY, **STEP)
    cfg = _port_cfg(FPN_FP16, over)
    assert cfg.fp16 == dict(loss_scale=512.0) and 'dtype' not in cfg.model
    assert ttrain.train_model_cfg(cfg)['dtype'] == 'bfloat16'
    trainer = ttrain.init_trainer(cfg, device='cpu', steps_per_epoch=1)
    assert trainer.model.dtype == torch.bfloat16
    assert trainer.model.neck.fpn_conv_0.compute_dtype == torch.bfloat16
    assert tapis.init_detector(cfg, device='cpu').model.dtype == \
        torch.float32
    cfg = _port_cfg(FPN_FP16, dict(over, **{'model.dtype': 'float32'}))
    assert ttrain.init_trainer(cfg, device='cpu',
                               steps_per_epoch=1).model.dtype == \
        torch.float32


def test_cfg_options_dtype_reaches_trainer_and_detector(tmp_path):
    """`--cfg-options model.dtype=bfloat16` on the DA command line sets the
    nested flagship-style config's compute type (the JAX builder drops a
    nested config's dtype; the port takes it), for training and serving."""
    args = tda_train.parse_args([DC5_TINY, '--work-dir', str(tmp_path),
                                 '--cfg-options', 'model.dtype=bfloat16'])
    cfg = tda_train.load_config(args)
    assert cfg.model.dtype == 'bfloat16'
    trainer = ttrain.init_trainer(cfg, device='cpu', steps_per_epoch=1)
    assert trainer.model.backbone.trunk.layer4[0].conv1.compute_dtype == \
        torch.bfloat16
    bundle = tapis.init_detector(cfg, device='cpu')
    assert bundle.model.dtype == torch.bfloat16
    rs = np.random.RandomState(0)
    res = tapis.inference_detector(bundle, rs.randint(
        0, 256, (64, 96, 3), dtype=np.uint8))
    assert len(res) == 2 and all(np.isfinite(r).all() for r in res)


@pytest.mark.parametrize('entry', ['build', 'serve', 'train', 'loop'])
def test_float16_raises(entry, tmp_path):
    cfg = _port_cfg(DC5_TINY, {'model.dtype': 'float16'})
    with pytest.raises(NotImplementedError, match='float16'):
        if entry == 'build':
            tbuilder.build_detector(cfg.model, device='meta')
        elif entry == 'serve':
            tapis.init_detector(cfg, device='cpu')
        elif entry == 'train':
            ttrain.init_trainer(cfg, device='cpu', steps_per_epoch=1)
        else:
            ttrain.train_detector(cfg, str(tmp_path / 'wd'), device='cpu')
    assert not (tmp_path / 'wd').exists()


def test_profile_train_takes_the_compute_type(tmp_path):
    """`tools.profile_train --cfg-options model.dtype=bfloat16` profiles the
    bf16 step (the same stages as the f32 one) and records its type."""
    result = tprofile.main([
        '--device', 'cpu', '--size', '64', '96', '--steps', '1',
        '--config', DC5_TINY, '--cfg-options', 'model.dtype=bfloat16',
        *NARROW_OPTIONS, '--out', str(tmp_path / 'profile.json')])
    assert result['dtype'] == 'torch.bfloat16'
    assert result['cfg_options'] == ['model.dtype=bfloat16',
                                     *NARROW_OPTIONS]
    assert 'backward' in result['stage_host_ms']
