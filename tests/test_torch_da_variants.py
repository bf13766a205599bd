"""The rest of the DA family in the port against the JAX package: the MHSA
attention and the MHSA global head, MAF's SRM head, DAF-original's image
head and its two losses, then `predict` and two train steps of the tiny
DAF-original ('daf_org' taps, 'plain' instances, consistency loss) and
MAF ('srm' taps, 'split_plain') detectors against `make_train_step` (SWDA,
DeepAlign and Tri-attention in `test_torch_da_variants_steps.py`), and
the converter on every new configuration at full width.

Weights and inputs come from numpy seeds. Modules: outputs, input and
parameter gradients and batch statistics within 1e-5 of their scale.
Train steps (`two_steps`, shared with `test_torch_cyda.py`): per-term
losses within 1e-4 relative, parameters, EMA and momentum within 1e-4 of
scale, on a 128x192 canvas with dropout off and the same sampler
priorities on both sides; the JAX step is compiled without XLA:CPU's
algebraic simplifier, which gives the global heads NaN gradients under
jit. Each variant's weight seed is one whose second step flips no ReLU
unit between the two sides.
"""

import importlib
import pathlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .test_torch_da import _train_both
from .test_torch_train import (_close_scaled, _converted, _demo_batch,
                               _jax_fixed_samplers, _no_dropout, _tiny_cfg)
from .torch_port_utils import (JAX_PKG, PARITY_THREADS, PORT_PKG, fill_variables,
                               torch_threads)

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = str(ROOT / 'configs/da/faster_rcnn_r18_tiny_fixture.py')
HW = (128, 192)
# the configurations this slice brings to the port
CONFIGS = {
    'DAFasterRCNN_Org': 'configs/da/faster_rcnn_r50_daf_org_c2f.py',
    'MAFasterRCNN': 'configs/da/faster_rcnn_r50_maf_c2f.py',
    'FasterRCNN_SWDA': 'configs/da/faster_rcnn_r50_swda_c2f.py',
    'DAFasterRCNN_Deep': 'configs/da/faster_rcnn_r50_deep_c2f.py',
    'DAFasterRCNN_Tri': 'configs/da/faster_rcnn_r50_tri_c2f.py',
    'CyDAFasterRCNN': 'configs/da/faster_rcnn_r50_cyda_c2f.py',
    'CyCADA': 'configs/da/cycada_pretrain_c2f.py',
}
# each variant's loss keys, as the JAX detector names them
KEYS = {
    'DAFasterRCNN_Org': {'img_da_loss', 'local_da_loss', 'consist_loss'},
    'MAFasterRCNN': {'globle_da_loss', 'local_da_loss'},
    'FasterRCNN_SWDA': {'globle_da_loss', 'patch_bottom_loss',
                        'local_da_loss'},
    'DAFasterRCNN_Deep': {'globle_da_loss', 'patch_bottom_loss',
                          'local_da_loss'},
    'DAFasterRCNN_Tri': {'globle_da_loss', 'patch_bottom_loss',
                         'local_da_loss'},
}
DET_KEYS = {'loss_rpn_cls', 'loss_rpn_bbox', 'loss_cls', 'loss_bbox'}

jatt = importlib.import_module(f'{JAX_PKG}.models.layers.attention')
jheads = importlib.import_module(f'{JAX_PKG}.models.da.heads')
jdal = importlib.import_module(f'{JAX_PKG}.models.da.losses')
jbuilder = importlib.import_module(f'{JAX_PKG}.models.builder')
jconfig = importlib.import_module(f'{JAX_PKG}.utils.config')
jts = importlib.import_module(f'{JAX_PKG}.apis.train_state')
tatt = importlib.import_module(f'{PORT_PKG}.models.layers.attention')
theads = importlib.import_module(f'{PORT_PKG}.models.da.heads')
tdal = importlib.import_module(f'{PORT_PKG}.models.da.losses')
tbuilder = importlib.import_module(f'{PORT_PKG}.models.builder')
ttrain = importlib.import_module(f'{PORT_PKG}.apis.train')
tconfig = importlib.import_module(f'{PORT_PKG}.utils.config')
convert = importlib.import_module(f'{PORT_PKG}.utils.convert')


def _t(x):
    return torch.from_numpy(np.array(x))


# ---- modules ---------------------------------------------------------------

def test_mhsa():
    """The k conv's bias shifts each query's logits by a constant, so its
    true gradient is 0 and both sides give rounding noise of ~1e-6: the
    parameter gradients (of order 1 here) are held to 1e-5 of at least 1."""
    x = np.random.RandomState(20).standard_normal((2, 5, 7, 32)).astype(
        np.float32)
    _train_both(jatt.MHSA(32), tatt.MHSA(32, (5, 7)), x, 21, map_out=True,
                tol=1e-5, grad_floor=1.0)
    with pytest.raises(ValueError, match='MHSA built for'):
        tatt.MHSA(32, (5, 7))(torch.zeros(1, 32, 6, 7))


@pytest.mark.parametrize('hw', [(8, 12), (7, 9)])
def test_mhsa_global_head(hw):
    """The Tri-attention global head; its attention map is the input
    halved by the stride-2 conv1 (rounding up)."""
    x = np.random.RandomState(22).standard_normal((2,) + hw + (64,)).astype(
        np.float32)
    map_hw = tuple(-(-n // 2) for n in hw)
    _train_both(jheads.GlobalAlignmentHead(64, attention='mhsa'),
                theads.GlobalAlignmentHead(64, attention='mhsa',
                                           map_hw=map_hw), x, 23, tol=1e-5)


def test_srm_head():
    """MAF's head: the 3x3 conv padded by 3 grows the map by 4 before the
    pool, to 9·C/4 channels."""
    x = np.random.RandomState(24).standard_normal((2, 6, 9, 32)).astype(
        np.float32)
    head = theads.SRMHead(32)
    assert head.conv2.out_channels == 72 and head.conv2.padding == (3, 3)
    _train_both(jheads.SRMHead(32), head, x, 25, tol=1e-5)


def test_image_alignment_head():
    x = np.random.RandomState(26).standard_normal((2, 5, 6, 40)).astype(
        np.float32)
    _train_both(jheads.ImageAlignmentHead(40),
                theads.ImageAlignmentHead(40), x, 27, tol=1e-5)


def test_image_da_and_consistency_losses():
    rs = np.random.RandomState(28)
    lm = rs.standard_normal((2, 5, 6, 1)).astype(np.float32)
    ins = rs.standard_normal((2, 7, 2)).astype(np.float32)
    valid = rs.uniform(size=(2, 7)) < 0.7
    domain = np.array([0, 1], np.int32)
    jv, jg = jax.value_and_grad(lambda m: jdal.image_da_loss(
        m, jnp.asarray(domain)))(jnp.asarray(lm))
    mt = _t(lm).requires_grad_()
    tv = tdal.image_da_loss(mt, _t(domain))
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-5)
    np.testing.assert_allclose(mt.grad.numpy(), jg, rtol=0,
                               atol=1e-5 * np.abs(jg).max())
    jv, (gm, gi) = jax.value_and_grad(
        lambda m, i: jdal.consistency_loss(m, i, jnp.asarray(valid),
                                           jnp.asarray(domain)),
        argnums=(0, 1))(jnp.asarray(lm), jnp.asarray(ins))
    mt, it = _t(lm).requires_grad_(), _t(ins).requires_grad_()
    tv = tdal.consistency_loss(mt, it, _t(valid), _t(domain))
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-5)
    for got, ref in ((mt.grad, gm), (it.grad, gi)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


# ---- the converter at full width -------------------------------------------

@pytest.mark.parametrize('det_type', sorted(CONFIGS))
def test_converter_maps_every_leaf_at_full_width(det_type):
    """Each new configuration at full width (R50-DC5, 8 classes, the
    512x1024 training canvas): every leaf of the JAX variable tree of a
    train step (`jax.eval_shape`, no compute) maps onto the port's
    detector with its shape, none is left over, and the JAX parameters
    cover the port's but for CyCADA's detector, which the JAX package does
    not create in its translation phase. The MHSA position terms are
    16x32, the C4 and dilated C5 maps halved."""
    path = str(ROOT / CONFIGS[det_type])
    model = jbuilder.build_detector(jconfig.Config.fromfile(path).model)
    b, (h, w) = 2, (512, 1024)
    dummy = dict(image=jnp.zeros((b, h, w, 3)),
                 img_shape=jnp.full((b, 2), h, jnp.int32),
                 gt_bboxes=jnp.zeros((b, 4, 4)),
                 gt_labels=jnp.zeros((b, 4), jnp.int32),
                 gt_valid=jnp.zeros((b, 4), bool),
                 domain=jnp.array([0, 1], jnp.int32))
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: model.init(
        {'params': k, 'sampler': k, 'dropout': k}, dummy, train=True))
    tree = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), shapes)
    cfg = tconfig.Config.fromfile(path)
    port = tbuilder.build_detector(cfg.model, device='meta',
                                   canvas=tbuilder.train_canvas(cfg))
    assert tbuilder.train_canvas(cfg) == (512, 1024)
    state, unmapped = convert.from_jax_variables(tree, port)
    assert unmapped == []
    target = port.state_dict()
    for key, v in state.items():
        assert tuple(v.shape) == tuple(target[key].shape), key
    missing = set(target) - set(state)
    if det_type == 'CyCADA':
        assert missing and all(not n.startswith(('gen_', 'disc_'))
                               for n in missing)
    else:
        assert not missing
    if det_type == 'DAFasterRCNN_Tri':
        assert tuple(target['backbone.global_s2_2.mhsa.rel_h'].shape) == \
            (16, 1, 512)
        assert tuple(target['backbone.global_s3_3.mhsa.rel_w'].shape) == \
            (1, 32, 1024)


# ---- two train steps of a tiny detector ------------------------------------

def _jax_model(det_type, **fields):
    jcfg = jconfig.Config.fromfile(TINY)
    jcfg.model['type'] = det_type
    model = jbuilder.build_detector(jcfg.model)
    return model.clone(**fields) if fields else model


def _jax_variables(model, jbatch, seed):
    k0 = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: model.init(
        {'params': k0, 'sampler': k0, 'dropout': k0}, jbatch, train=True))
    return fill_variables(shapes, np.random.RandomState(seed))


def two_steps(det_type, seed, port_options=None, jax_fields=None,
              variables=None):
    """`predict`, then `steps` train steps, of the tiny-fixture detector of
    `det_type` on both sides from the same weights (`seed`'s, or
    `variables`, a superset of the JAX tree), dropout off, the same sampler
    priorities. `port_options` merge into the port's config, `jax_fields`
    replace the JAX module's fields. The CycleGAN detectors step with the
    two-group GAN step on both sides, the rest with `make_train_step` (NaN
    guard and EMA on)."""
    cfg = _tiny_cfg()
    cfg.merge_from_dict({'model.type': det_type, **(port_options or {})})
    for dataset in cfg.data.train.datasets:     # the canvas of the MHSA heads
        for t in dataset.pipeline:
            if t['type'] == 'Pad':
                t['size'] = HW
    assert tbuilder.train_canvas(cfg) == HW
    model = _jax_model(det_type, **(jax_fields or {}))
    batch = _demo_batch(h=HW[0], w=HW[1])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jvars = _jax_variables(model, jbatch, seed)
    if variables is not None:
        jvars = {c: {k: variables[c][k] for k in jvars.get(c, {})}
                 for c in jvars}
    trainer = ttrain.init_trainer(cfg, variables=variables or jvars,
                                  device='cpu', steps_per_epoch=1)
    gan = isinstance(trainer.optimizer, tuple)
    for m in trainer.model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0

    # serving: plain Faster R-CNN on both sides, on the images and shapes
    # of `test_torch_detector.py::test_predict_matches`
    rs = np.random.RandomState(3)
    image = rs.standard_normal((2, 64, 96, 3)).astype(np.float32)
    img_shape = np.array([[64, 96], [56, 80]], np.int32)
    ref_pred = jax.jit(lambda v, bt: model.apply(v, bt, train=False))(
        jvars if 'backbone' in jvars['params'] else variables,
        dict(image=jnp.asarray(image), img_shape=jnp.asarray(img_shape)))
    got_pred = trainer.model.predict(dict(image=_t(image),
                                          img_shape=_t(img_shape)))

    tbatch = {k: _t(v) for k, v in batch.items()}
    start = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    rpn_key, roi_key = jax.random.PRNGKey(21), jax.random.PRNGKey(22)
    anchors = (HW[0] // 16) * (HW[1] // 16) * 6
    cands = batch['gt_bboxes'].shape[1] + 64
    pri = dict(rpn=_t(jax.random.uniform(rpn_key, (anchors,))).expand(2, -1),
               rcnn=_t(jax.random.uniform(roi_key, (cands,))).expand(2, -1))

    jmetrics, tmetrics = [], []
    state = trainer.state
    with _jax_fixed_samplers(rpn_key, roi_key), \
            fnn.intercept_methods(_no_dropout):
        spec = jts.OptimizerSpec(**trainer.spec._asdict())
        if gan:
            jstate, tx_main, tx_disc = jts.create_gan_train_state(
                model, jvars, spec, frozen_stages=1)
            jstep = jax.jit(jts.make_gan_train_step(model, tx_main,
                                                    tx_disc))
        else:
            jstate, tx = jts.create_train_state(model, jvars, spec,
                                                frozen_stages=1, ema=True)
            jstep = jax.jit(jts.make_train_step(
                model, tx, skip_nonfinite=True, ema_momentum=0.9995))
        jstep = jstep.lower(jstate, jbatch, jax.random.PRNGKey(3)).compile(
            compiler_options={'xla_disable_hlo_passes': 'algsimp'})
        for _ in range(2):
            jstate, m = jstep(jstate, jbatch, jax.random.PRNGKey(3))
            jmetrics.append(jax.tree_util.tree_map(np.asarray, m))
            with torch_threads(PARITY_THREADS):
                state, m = trainer.step(state, tbatch,
                                        sampler_priorities=pri)
            tmetrics.append({k: v.numpy() for k, v in m.items()})
        jstate = jax.device_get(jstate)
    return dict(jstate=jstate, jmetrics=jmetrics, trainer=trainer,
                state=state, tmetrics=tmetrics, start=start, gan=gan,
                pred=(got_pred, ref_pred), model=model, jvars=jvars)


def check_predict(run):
    got, ref = run['pred']
    valid = np.asarray(ref['valid'])
    assert valid.sum() >= 10
    np.testing.assert_array_equal(got['valid'].numpy(), valid)
    np.testing.assert_array_equal(got['labels'].numpy(),
                                  np.asarray(ref['labels']))
    np.testing.assert_allclose(got['dets'].numpy(), np.asarray(ref['dets']),
                               atol=1e-3)


def check_losses(run, keys, rtol=1e-4):
    """Both steps' loss terms: the JAX keys, finite, within `rtol`
    relative."""
    for jm, tm in zip(run['jmetrics'], run['tmetrics']):
        assert set(tm) == set(jm)
        assert keys <= set(tm)
        for k in jm:
            assert np.isfinite(tm[k]), k
            np.testing.assert_allclose(np.float64(tm[k]), np.float64(jm[k]),
                                       rtol=rtol, atol=rtol * 1e-2,
                                       err_msg=k)
        assert tm.get('skipped_nonfinite', 0) == 0


def check_state(run, tol=1e-4, mom_tols=(),
                frozen=('backbone.trunk.conv1', 'backbone.trunk.bn1',
                        'backbone.trunk.layer1.')):
    """Parameters and batch statistics within `tol` of scale of the JAX
    ones, every leaf the JAX tree has; the frozen stem and layer1
    bit-identical to the start and every other parameter moved; momentum
    (both groups' for the GAN step) within `tol` of each tensor's largest
    entry or of 1e-3, or within the tolerance of the first (prefixes,
    tolerance) pair of `mom_tols` whose prefix the name has (the port
    keeps none for frozen parameters, whose JAX buffers stay 0); the EMA
    within `tol` of scale. Returns the port's parameters the JAX tree
    lacks."""
    trainer, jstate, state = run['trainer'], run['jstate'], run['state']
    model = trainer.model
    ref, unmapped = convert.from_jax_variables(
        {'params': jstate.params, 'batch_stats': jstate.batch_stats}, model)
    assert unmapped == []
    got = model.state_dict()
    params = dict(model.named_parameters())
    assert state.step == 2
    for k, v in got.items():
        if k not in ref:
            continue
        _close_scaled(v.numpy(), ref[k].numpy(), tol, name=k)
        if k.startswith(frozen):
            assert torch.equal(v, run['start'][k]), k
        elif k in params:
            assert not torch.equal(v, run['start'][k]), k
    if run['gan']:
        opts = list(zip(state.opt_state, jstate.opt_state))
    else:
        opts = [(state.opt_state, jstate.opt_state)]
        ema = _converted({'params': jstate.ema_params}, model)
        for k, e in state.ema_params.items():
            _close_scaled(e.numpy(), ema[k].numpy(), tol, name=k)
    for tstate, jopt in opts:
        assert tstate.count == int(jopt.count) == 2
        mom = _converted({'params': jopt.momentum}, model)
        for k, m in mom.items():
            if k in tstate.momentum:
                k_tol = next((t for pre, t in mom_tols
                              if k.startswith(pre)), tol)
                _close_scaled(tstate.momentum[k].numpy(), m.numpy(), k_tol,
                              floor=1e-3, name=k)
            else:                       # frozen: the JAX buffer stays 0
                assert not np.any(m.numpy()), k
    return {k for k in params if k not in ref}


# weight seeds whose second step flips no ReLU unit between the two sides;
# this file runs the first two, `test_torch_da_variants_steps.py` the rest
SEEDS = {'DAFasterRCNN_Org': 8, 'MAFasterRCNN': 3, 'FasterRCNN_SWDA': 15,
         'DAFasterRCNN_Deep': 9, 'DAFasterRCNN_Tri': 5}
# the tap that only this variant has
OWN_TAP = {'DAFasterRCNN_Org': 'image_s3_0', 'MAFasterRCNN': 'srm_s1_0',
           'FasterRCNN_SWDA': 'global_s2_1', 'DAFasterRCNN_Deep': 'pixel_s2_1',
           'DAFasterRCNN_Tri': 'global_s3_3'}


def variant_run(det_type):
    run = two_steps(det_type, SEEDS[det_type])
    run['det_type'] = det_type
    return run


def check_variant(run):
    """`predict`, then both train steps and the state after them."""
    check_predict(run)
    check_losses(run, DET_KEYS | KEYS[run['det_type']])
    assert check_state(run) == set()
    assert hasattr(run['trainer'].model.backbone, OWN_TAP[run['det_type']])


@pytest.mark.parametrize('det_type', ['DAFasterRCNN_Org', 'MAFasterRCNN'])
def test_variant_predict_and_train_steps_match(det_type):
    check_variant(variant_run(det_type))
