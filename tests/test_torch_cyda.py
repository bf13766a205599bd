"""CyDA and CyCADA in the port against the JAX package: the instance norm,
the nearest 2x upsampling, the ResNet generator, the PatchGAN
discriminator and the GAN losses; `translate`, the gradient paths of the
detector and the CycleGAN objective's gradients in float64; and a CPU run
of the training loop's GAN branch with a bit-exact resume. `predict` and
two train steps against `make_gan_train_step` are in
`test_torch_cyda_steps.py`.

Modules: outputs, input and parameter gradients within 1e-5 of their
scale; the upsampling exactly; the float64 objective within 1e-9.
"""

import importlib
import json
import pathlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .test_torch_da import _train_both
from .test_torch_da_variants import (DET_KEYS, HW, _demo_batch, _jax_model,
                                     _jax_variables)
from .torch_port_utils import JAX_PKG, NARROW_OPTIONS, PORT_PKG

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = str(ROOT / 'configs/da/faster_rcnn_r18_tiny_fixture.py')
GAN_KEYS = {'cycle_loss', 'gan_g_loss', 'disc_loss'}
# a weight seed whose steps agree within the tolerances stated below
SEED = 6

jgan = importlib.import_module(f'{JAX_PKG}.models.da.cyclegan')
jganloss = importlib.import_module(f'{JAX_PKG}.models.losses.gan_loss')
tnorm = importlib.import_module(f'{PORT_PKG}.models.layers.norm')
tgan = importlib.import_module(f'{PORT_PKG}.models.da.cyclegan')
tganloss = importlib.import_module(f'{PORT_PKG}.models.losses.gan_loss')
tbuilder = importlib.import_module(f'{PORT_PKG}.models.builder')
tconfig = importlib.import_module(f'{PORT_PKG}.utils.config')
ttrain = importlib.import_module(f'{PORT_PKG}.apis.train')
ckpt_io = importlib.import_module(f'{PORT_PKG}.utils.checkpoint')
convert = importlib.import_module(f'{PORT_PKG}.utils.convert')
da_train = importlib.import_module(f'{PORT_PKG}.tools.DA_train')


def _t(x):
    return torch.from_numpy(np.array(x))


# ---- modules ---------------------------------------------------------------

def test_instance_norm():
    """flax's GroupNorm with one channel a group: ε 1e-6 and the fast
    variance, on maps with a large mean (where E[x²] − E[x]² loses most)
    and one channel constant (variance clamped at 0)."""
    x = (5 + np.random.RandomState(30).standard_normal((2, 6, 7, 12))
         ).astype(np.float32)
    x[..., 3] = 2.0
    _train_both(fnn.GroupNorm(num_groups=None, group_size=1),
                tnorm.InstanceNorm(12), x, 31, map_out=True, tol=1e-5)
    assert tnorm.InstanceNorm(12).epsilon == 1e-6


@pytest.mark.parametrize('hw', [(4, 6), (5, 7)])
def test_upsample_nearest_2x_equals_jax_resize(hw):
    x = np.random.RandomState(32).standard_normal((2,) + hw + (3,)).astype(
        np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, 2 * hw[0], 2 * hw[1], 3),
                           method='nearest')
    got = tgan.upsample_nearest_2x(_t(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(ref))


def test_resnet_generator():
    """Each conv in front of an instance norm has a bias whose true
    gradient is 0 (the norm removes a per-channel shift); both sides give
    rounding noise of up to ~2e-5 there. The other parameter gradients are
    of order 10-60, so parameter gradients are held to 1e-5 of at least
    10."""
    x = np.random.RandomState(33).uniform(-1, 1, (2, 16, 24, 3)).astype(
        np.float32)
    _train_both(jgan.ResnetGenerator(base=8, n_blocks=1),
                tgan.ResnetGenerator(base=8, n_blocks=1), x, 34,
                map_out=True, tol=1e-5, grad_floor=10.0)


def test_patch_discriminator():
    x = np.random.RandomState(35).standard_normal((2, 32, 48, 3)).astype(
        np.float32)
    _train_both(jgan.PatchDiscriminator(base=8),
                tgan.PatchDiscriminator(base=8), x, 36, map_out=True,
                tol=1e-5)


def test_gan_losses():
    rs = np.random.RandomState(37)
    logits = rs.standard_normal((2, 3, 4, 1)).astype(np.float32)
    a, b = rs.standard_normal((2, 2, 5, 6, 3)).astype(np.float32)
    for real in (True, False):
        jv, jg = jax.value_and_grad(lambda v: jganloss.gan_lsgan_loss(
            v, real))(jnp.asarray(logits))
        lt = _t(logits).requires_grad_()
        tv = tganloss.gan_lsgan_loss(lt, real)
        tv.backward()
        np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-5)
        np.testing.assert_allclose(lt.grad.numpy(), jg, rtol=1e-5)
    jv, jg = jax.value_and_grad(lambda v: jganloss.cycle_consistency_loss(
        jnp.asarray(a), v, 10.0))(jnp.asarray(b))
    bt = _t(b).requires_grad_()
    tv = tganloss.cycle_consistency_loss(_t(a), bt, 10.0)
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-5)
    np.testing.assert_allclose(bt.grad.numpy(), jg, rtol=1e-5)


# ---- the detectors ----------------------------------------------------------

@pytest.fixture(scope='module')
def cyda_variables():
    """The tiny CyDA detector's JAX variables (one generator block): the
    whole tree, detector included; CyCADA's JAX tree is its generator and
    discriminator part."""
    batch = _demo_batch(h=HW[0], w=HW[1])
    return _jax_variables(_jax_model('CyDAFasterRCNN', gen_blocks=1),
                          {k: jnp.asarray(v) for k, v in batch.items()},
                          SEED)


# distinct weights of the three CycleGAN terms in the float64 check
WEIGHTS = {'cycle_loss': 1.0, 'gan_g_loss': 0.37, 'disc_loss': 2.3}


def test_cyclegan_gradients_match_in_float64(cyda_variables):
    """CyCADA's loss is the CycleGAN objective alone. In float64 on both
    sides (JAX under `jax.enable_x64`), at 32x48, its three terms agree
    within 1e-9 relative, and the gradient of a combination of them with
    distinct weights (1, 0.37 and 2.3), with respect to every generator
    and discriminator parameter, within 1e-9 of its scale: the float32
    gaps of the train steps are rounding, not a difference of formula."""
    model = _jax_model('CyCADA', gen_blocks=1)
    port = _tiny_cyda('CyCADA').double().train()
    state, _ = convert.from_jax_variables(cyda_variables, port)
    port.load_state_dict({k: v.double() for k, v in state.items()})
    batch = _demo_batch(h=32, w=48)
    tb = {k: _t(v) for k, v in batch.items()}
    tb['image'] = tb['image'].double()
    losses = port.loss(tb)
    gan = {n: p for n, p in port.named_parameters()
           if n.startswith(('gen_', 'disc_'))}
    params64 = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64),
        {k: v for k, v in cyda_variables['params'].items()
         if k.startswith(('gen_', 'disc_'))})
    with jax.enable_x64():
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jb['image'] = jnp.asarray(batch['image'], jnp.float64)
        def terms_and_grad(p):
            values, vjp = jax.vjp(lambda q: model.apply(
                {'params': q}, jb, train=True), p)
            return values, vjp({k: jnp.float64(WEIGHTS[k])
                                for k in values})[0]

        values, grads = jax.jit(terms_and_grad)(params64)
    for term in sorted(GAN_KEYS):
        np.testing.assert_allclose(losses[term].item(), float(values[term]),
                                   rtol=1e-9)
    ref, _ = convert.from_jax_variables(
        {'params': jax.tree_util.tree_map(np.asarray, grads)}, port)
    got = torch.autograd.grad(sum(w * losses[k] for k, w in WEIGHTS.items()),
                              list(gan.values()), allow_unused=True)
    for (n, _), g in zip(gan.items(), got):
        r = ref[n].numpy()
        g = np.zeros_like(r) if g is None else g.numpy()
        np.testing.assert_allclose(
            g, r, rtol=0, atol=1e-9 * max(np.abs(r).max(), 1e-3), err_msg=n)


def _tiny_cyda(det_type='CyDAFasterRCNN', frozen_stages=1):
    cfg = tconfig.Config.fromfile(TINY)
    cfg.model['type'] = det_type
    cfg.model['gen_blocks'] = 1
    cfg.model['backbone']['frozen_stages'] = frozen_stages
    return tbuilder.build_detector(cfg.model, device='cpu')


def test_translate_matches(cyda_variables):
    model = _jax_model('CyDAFasterRCNN', gen_blocks=1)
    port = _tiny_cyda()
    assert convert.load_jax_variables(port, cyda_variables) == []
    image = np.random.RandomState(38).standard_normal(
        (2, 64, 96, 3)).astype(np.float32)
    ref = model.apply(cyda_variables, dict(image=jnp.asarray(image)),
                      method=model.translate)
    got = port.translate(dict(image=_t(image)))
    assert got.shape == (2, 64, 96, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(ref)).max())


def _gen_grads(model, loss):
    return torch.autograd.grad(
        loss, [model.gen_s2t.enc0.weight, model.gen_t2s.enc0.weight],
        retain_graph=True, allow_unused=True)


def test_gradient_paths_and_the_callers_batch():
    """The detector trains on the translated source rows, built without
    writing into the caller's batch. With a trainable stem the detection
    losses reach `gen_s2t` (not `gen_t2s`); with the configs' frozen stem
    they stop at the image, as the JAX trunk's stop_gradient at its frozen
    stages stops them, so the translation trains on the GAN and cycle terms
    alone. The discriminators' loss reaches no generator, and CyCADA's
    losses reach no detector parameter."""
    batch = {k: _t(v) for k, v in _demo_batch(h=64, w=96).items()}
    image = batch['image'].clone()
    torch.manual_seed(0)
    for frozen_stages in (-1, 1):
        model = _tiny_cyda(frozen_stages=frozen_stages).train()
        losses = model.loss(batch,
                            generator=torch.Generator().manual_seed(1))
        assert torch.equal(batch['image'], image)
        assert set(losses) == GAN_KEYS | DET_KEYS | {'globle_da_loss'}
        g_s2t, g_t2s = _gen_grads(model, losses['loss_cls'])
        assert g_t2s is None
        if frozen_stages < 0:
            assert float(g_s2t.abs().max()) > 0
        else:
            assert g_s2t is None
        assert _gen_grads(model, losses['disc_loss']) == (None, None)
    cycada = _tiny_cyda('CyCADA').train()
    assert cycada.pretraining
    losses = cycada.loss(batch)
    assert set(losses) == GAN_KEYS
    det = [p for n, p in cycada.named_parameters() if p.requires_grad
           and n.startswith(('backbone.', 'rpn_head.', 'bbox_head.'))]
    assert all(g is None for g in torch.autograd.grad(
        sum(losses.values()), det, allow_unused=True))


@pytest.mark.parametrize('det_type', ['CyDAFasterRCNN', 'CyCADA',
                                      'DAFasterRCNN_Org', 'FasterRCNN'])
def test_builder_reads_gen_blocks_of_a_nested_config(det_type):
    """Of a nested config's top-level keys, `gen_blocks` alone reaches the
    detector, and only one that takes it (the JAX builder drops it); the
    MHSA canvas comes from the caller alone."""
    cfg = tconfig.Config.fromfile(TINY)
    cfg.merge_from_dict({'model.type': det_type, 'model.gen_blocks': 2,
                         'model.global_weight': 0.5})
    model = tbuilder.build_detector(cfg.model, device='meta')
    if det_type.startswith('Cy'):
        assert model.gen_s2t.n_blocks == model.gen_t2s.n_blocks == 2
        assert model.global_weight == 0.1
    else:
        assert not hasattr(model, 'gen_s2t')
    tri = dict(cfg.model, type='DAFasterRCNN_Tri', canvas=(128, 192))
    assert tbuilder.build_detector(tri, device='meta').canvas == (512, 1024)
    assert tbuilder.build_detector(tri, device='meta',
                                   canvas=(64, 96)).canvas == (64, 96)


def test_detector_images_are_what_the_step_detects_on():
    """`detector_images` (which `chip_smoke.py` holds the RoIAlign pair
    on) is exactly the trunk's input in a train step's loss: the source
    rows translated, the target rows raw."""
    batch = {k: _t(v) for k, v in _demo_batch(h=64, w=96).items()}
    torch.manual_seed(0)
    model = _tiny_cyda().train()
    seen = []
    hook = model.backbone.register_forward_pre_hook(
        lambda module, args: seen.append(args[0].detach().clone()))
    model.loss(batch, generator=torch.Generator().manual_seed(1))
    hook.remove()
    got = model.detector_images(batch)
    assert len(seen) == 1 and got.shape == batch['image'].shape
    assert torch.equal(got.permute(0, 3, 1, 2), seen[0])
    assert torch.equal(got[1::2], batch['image'][1::2])
    assert torch.equal(got[0::2], model.translate(
        dict(image=batch['image'][0::2])))


# ---- the loop's GAN branch -------------------------------------------------

def _argv(work_dir, *extra):
    paths = []
    for key, sub in (('data.train.datasets.0', 'voc_source'),
                     ('data.train.datasets.1', 'voc_target'),
                     ('data.val', 'voc_target'), ('data.test', 'voc_target')):
        split = 'train' if 'train' in key else 'test'
        paths += [f'{key}.ann_file={ROOT}/tests/data/{sub}/ImageSets/Main/'
                  f'{split}.txt', f'{key}.img_prefix={ROOT}/tests/data/{sub}/']
    return [TINY, '--work-dir', str(work_dir), '--device', 'cpu',
            '--cfg-options', *paths, *NARROW_OPTIONS,
            'model.type=CyDAFasterRCNN', 'model.gen_blocks=1',
            'ema.momentum=0.9995', *extra]


def test_gan_loop_trains_checkpoints_and_resumes_bit_for_bit(tmp_path):
    """`tools.DA_train` with the CyDA detector: 1 epoch and its checkpoint,
    then a resume from ckpt_1 into a second epoch whose restored state —
    parameters,
    buffers, both optimizers' momentum (the discriminators' included) and
    counts — equals what was saved, bit for bit. The GAN step keeps no EMA
    even though the run asks for one."""
    restored = []
    orig = ttrain.restore_train_state

    def spy(model, state, ckpt):
        state = orig(model, state, ckpt)
        assert isinstance(state.opt_state, tuple) and \
            len(state.opt_state) == 2
        restored.append({k: ({n: t.detach().clone() for n, t in v.items()}
                             if isinstance(v, dict) else v)
                         for k, v in ckpt_io.train_state_dict(
                             model, state).items()})
        return state

    ttrain.restore_train_state = spy
    try:
        da_train.main(_argv(tmp_path, 'runner.max_epochs=1'))
        saved = ckpt_io.load_checkpoint(str(tmp_path / 'ckpt_1'))
        da_train.main(_argv(tmp_path, '--resume-from',
                            str(tmp_path / 'ckpt_1')))
        assert (tmp_path / 'ckpt_2').exists()
    finally:
        ttrain.restore_train_state = orig
    recs = [json.loads(line) for line in open(tmp_path / 'train_log.jsonl')]
    train = [r for r in recs if r['mode'] == 'train']
    assert train and all(GAN_KEYS | {'loss'} <= set(r) for r in train)
    assert all(np.isfinite(r['loss']) for r in train)
    assert saved['ema_params'] is None
    assert any(n.startswith('disc_s.') for n in saved['momentum'])
    assert any(n.startswith('gen_s2t.') for n in saved['momentum'])
    (got,) = restored
    for key in ('step', 'opt_count'):
        assert got[key] == saved[key], key
    assert got['ema_params'] is None
    for key in ('params', 'buffers', 'momentum'):
        assert set(got[key]) == set(saved[key]), key
        for n, v in saved[key].items():
            assert torch.equal(got[key][n], v), f'{key}.{n}'
