"""The port's Swin slice against the JAX package, module by module: flax's
`LayerNorm`, the Swin trunk (f32 and bf16 forward, gradients under
`frozen_stages`), the DA trunk on Swin, the optimizers (SGD, Adam, AdamW,
paramwise groups, the frozen mask) against `make_optimizer`, the
classification-checkpoint converters, `PhotoMetricDistortion` and the
config loader on the Swin configs.

Weights and inputs come from numpy seeds and are carried across with
`from_jax_variables`. Tolerances: f32 outputs and gradients within 1e-5 of
their scale; bf16 outputs within `TOL_BF16` (2e-2) of the f32 output's
scale; optimizer updates within 1e-5 of the
parameters' scale after five clipped steps; converted checkpoints and the
photometric jitter exactly.
"""

import functools
import importlib
import pathlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .test_torch_bf16 import BF16
from .test_torch_train import _close_scaled
from .torch_port_utils import JAX_PKG, PORT_PKG, fill_variables

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY_SWIN = dict(embed_dims=16, depths=(2, 2, 2, 2), num_heads=(1, 2, 2, 4))
TOL_BF16 = 2e-2
SWIN_PW = dict(custom_keys={
    'absolute_pos_embed': dict(decay_mult=0.),
    'relative_position_bias_table': dict(decay_mult=0.),
    'norm': dict(decay_mult=0.)})

jswin = importlib.import_module(f'{JAX_PKG}.models.backbones.swin')
jda = importlib.import_module(f'{JAX_PKG}.models.backbones.da_resnet')
jts = importlib.import_module(f'{JAX_PKG}.apis.train_state')
jckpt = importlib.import_module(f'{JAX_PKG}.utils.checkpoint')
jtf = importlib.import_module(f'{JAX_PKG}.data.pipelines.transforms')
jconfig = importlib.import_module(f'{JAX_PKG}.utils.config')
tswin = importlib.import_module(f'{PORT_PKG}.models.backbones.swin')
tda = importlib.import_module(f'{PORT_PKG}.models.backbones.da_resnet')
tnorm = importlib.import_module(f'{PORT_PKG}.models.layers.norm')
tts = importlib.import_module(f'{PORT_PKG}.apis.train_state')
tckpt = importlib.import_module(f'{PORT_PKG}.utils.checkpoint')
ttf = importlib.import_module(f'{PORT_PKG}.data.pipelines.transforms')
tconfig = importlib.import_module(f'{PORT_PKG}.utils.config')
convert = importlib.import_module(f'{PORT_PKG}.utils.convert')


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).detach().float().numpy()


def _swin_variables(jm, x, seed, **kw):
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.asarray(x), **kw))
    return fill_variables(shapes, np.random.RandomState(seed))


# ---- LayerNorm -------------------------------------------------------------

@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_layer_norm_matches_flax(dtype):
    """On features with a large mean, where the fast variance E[x²] −
    E[x]² loses digits to the rounding of E[x]² (integer features, so every
    sum is exact in either order and both sides round alike): the port
    computes flax's statistics, not the two-pass ones of torch's
    `layer_norm`, which land ~1e-3 of scale away; at bf16 the statistics in
    f32 and the result in bf16."""
    import flax.linen as fnn
    rs = np.random.RandomState(0)
    x = (300.0 + rs.randint(-3, 4, (3, 5, 7, 24))).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jm = fnn.LayerNorm(dtype=jdt)
    tm = tnorm.LayerNorm(24, dtype=getattr(torch, dtype))
    v = fill_variables(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(x))), rs)
    assert convert.load_jax_variables(tm, v) == []
    ref = np.asarray(jm.apply(v, jnp.asarray(x, jdt)).astype(jnp.float32))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tm(xt)
    assert got.dtype == getattr(torch, dtype)
    if dtype == 'float32':
        _close_scaled(got.detach().numpy(), ref, 1e-6)
        two_pass = torch.nn.functional.layer_norm(
            xt, (24,), tm.scale, tm.bias, eps=1e-6).detach().numpy()
        assert np.abs(two_pass - ref).max() > 1e-4 * np.abs(ref).max()
    else:
        _close_scaled(got.float().detach().numpy(), ref, 2 ** -8)


# ---- the trunk -------------------------------------------------------------

@pytest.mark.parametrize('hw', [(70, 94), (69, 101)])
def test_swin_trunk_matches_all_stages(hw):
    """Every stage's output on canvases whose stages need window padding
    (stage 0 is 18x24 → 21x28 and 18x26 → 21x28) and, at 69x101, flax's
    uneven 'SAME' patch-embed padding (1 low, 2 high) and odd maps that
    the merges crop."""
    rs = np.random.RandomState(sum(hw))
    x = rs.standard_normal((2,) + hw + (3,)).astype(np.float32)
    jm = jswin.SwinTransformer(**TINY_SWIN)
    v = _swin_variables(jm, x, 1)
    tm = tswin.SwinTransformer(**TINY_SWIN)
    assert convert.load_jax_variables(tm, v) == []
    refs = jax.jit(lambda a, b: jm.apply(a, b, return_all_stages=True))(
        v, jnp.asarray(x))
    with torch.no_grad():
        gots = tm(_nchw(x), return_all_stages=True)
    assert tm.stage_channels() == (16, 32, 64, 128)
    for ref, got in zip(refs, gots):
        _close_scaled(_nhwc(got), np.asarray(ref), 1e-5)


def test_swin_trunk_bf16_within_tolerance():
    """Every stage at bf16 within `TOL_BF16` (2e-2) of the f32 output's
    scale from the jitted JAX trunk at bf16: criterion (a) of
    `test_torch_bf16.py`. Its criterion (b) does not hold through a
    transformer's depth: XLA fuses the bf16 elementwise steps (so the jitted
    JAX trunk rounds other than the eager one, by (b)'s measure up to 2x)
    and the ulp-level differences grow stage by stage."""
    rs = np.random.RandomState(5)
    x = rs.standard_normal((2, 70, 94, 3)).astype(np.float32)
    j32 = jswin.SwinTransformer(**TINY_SWIN)
    j16 = jswin.SwinTransformer(**TINY_SWIN, dtype=BF16)
    v = _swin_variables(j32, x, 2)
    tm = tswin.SwinTransformer(**TINY_SWIN, dtype=torch.bfloat16)
    assert convert.load_jax_variables(tm, v) == []
    f32 = jax.jit(lambda a, b: j32.apply(a, b, return_all_stages=True))(
        v, jnp.asarray(x))
    b16 = jax.jit(lambda a, b: j16.apply(a, b, return_all_stages=True))(
        v, jnp.asarray(x, BF16))
    with torch.no_grad():
        gots = tm(_nchw(x).bfloat16(), return_all_stages=True)
    for i, (got, rb, rf) in enumerate(zip(gots, b16, f32)):
        assert got.dtype == torch.bfloat16
        got = _nhwc(got)
        assert np.isfinite(got).all()
        _close_scaled(got, np.asarray(rb.astype(jnp.float32)), TOL_BF16,
                      floor=float(np.abs(np.asarray(rf)).max()),
                      name=f'stage {i}')


def test_swin_trunk_gradients_with_frozen_stages():
    """Input and parameter gradients of a weighted sum of every stage
    output, `frozen_stages=1`: the patch embed and stage 0 get exactly
    zero (the map is detached after stage 0, as the JAX trunk stops its
    gradient), everything else the JAX gradient."""
    rs = np.random.RandomState(7)
    x = rs.standard_normal((1, 60, 84, 3)).astype(np.float32)
    kw = dict(TINY_SWIN, frozen_stages=1)
    jm = jswin.SwinTransformer(**kw)
    v = _swin_variables(jm, x, 3)
    tm = tswin.SwinTransformer(**kw)
    assert convert.load_jax_variables(tm, v) == []
    outs = jax.eval_shape(lambda: jm.apply(v, jnp.asarray(x),
                                           return_all_stages=True))
    ws = [rs.standard_normal(o.shape).astype(np.float32) for o in outs]

    def loss(params, a):
        ys = jm.apply({'params': params}, a, return_all_stages=True)
        return sum(jnp.sum(y * w) for y, w in zip(ys, ws))

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(v['params'],
                                                     jnp.asarray(x))
    xt = _nchw(x).clone().requires_grad_(True)
    ys = tm(xt, return_all_stages=True)
    total = sum((y.permute(0, 2, 3, 1) * torch.from_numpy(w)).sum()
                for y, w in zip(ys, ws))
    total.backward()
    assert not np.any(np.asarray(gx))
    assert xt.grad is None or not xt.grad.any()
    ref = convert.from_jax_variables({'params': gp}, tm)[0]
    for name, p in tm.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        if name.startswith(('patch_', 'stage0.')):
            assert not g.any() and not ref[name].any(), name
        _close_scaled(g.numpy(), ref[name].numpy(), 1e-5, name=name)
    assert tm.stage1.block0.attn.rel_bias.grad.abs().sum() > 0


def test_swin_trunk_trains_after_serving():
    """The trunk's cached window index and shift mask, first made under
    `torch.inference_mode` (a request), serve a train step after it in the
    same process."""
    tswin._rel_index_on.cache_clear()
    tswin._shift_mask_on.cache_clear()
    tm = tswin.SwinTransformer(**TINY_SWIN)
    x = torch.randn(1, 3, 56, 56, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        tm(x)
    sum(o.sum() for o in tm(x, return_all_stages=True)).backward()
    assert tm.stage0.block1.attn.rel_bias.grad.abs().sum() > 0


def test_da_trunk_on_swin_taps_its_widths():
    """`DAResNet(trunk_type='swin')` with the DeepAlign taps: the Swin-T
    trunk's stage outputs and the taps' logits as the JAX module's, the
    taps at widths 192, 384, 384 and 768."""
    rs = np.random.RandomState(4)
    x = rs.standard_normal((2, 64, 96, 3)).astype(np.float32)
    geom = dict(trunk_type='swin', out_indices=(2,),
                taps=jda.VARIANT_TAPS['deep'])
    jm = jda.DAResNet(**geom)
    tm = tda.DAResNet(**dict(geom, taps=tda.VARIANT_TAPS['deep'])).eval()
    k = jax.random.PRNGKey(0)
    v = fill_variables(jax.eval_shape(lambda: jm.init(
        k, jnp.asarray(x), train=False)), rs)
    assert convert.load_jax_variables(tm, v) == []
    (ref,), jda_out = jax.jit(lambda a, b: jm.apply(a, b, train=False))(
        v, jnp.asarray(x))
    with torch.no_grad():
        (got,), tda_out = tm(_nchw(x))
    assert got.shape[1] == 384
    _close_scaled(_nhwc(got), np.asarray(ref), 1e-5)
    assert set(tda_out) == set(jda_out) == {
        'pixel_s1_0', 'pixel_s2_1', 'global_s2_2', 'global_s3_3'}
    for name, out in tda_out.items():
        _close_scaled(out.numpy(), np.asarray(jda_out[name]), 1e-5,
                      name=name)
    assert [getattr(tm, n).conv1.in_channels if n.startswith('pixel')
            else None for n in tm.tap_names][:2] == [192, 384]


# ---- optimizers ------------------------------------------------------------

@functools.lru_cache(maxsize=2)
def _param_tree(kind):
    """A JAX parameter tree (zeros: only its paths and shapes are read):
    a tiny Swin Mask R-CNN
    (trunk, FPN, RPN, box and mask heads) or the tiny DC5 DA detector,
    whose R18 trunk the frozen mask reaches."""
    jbuilder = importlib.import_module(f'{JAX_PKG}.models.builder')
    if kind == 'swin_mask':
        model = jbuilder.build_detector(dict(
            type='MaskRCNN', num_classes=3, neck_channels=16,
            backbone_cfg=dict(type='SwinTransformer', **TINY_SWIN)))
        batch = dict(image=jnp.zeros((1, 64, 64, 3)),
                     img_shape=jnp.full((1, 2), 64, jnp.int32))
        train = False
    else:
        cfg = jconfig.Config.fromfile(
            str(ROOT / 'configs/da/faster_rcnn_r18_tiny_fixture.py'))
        model = jbuilder.build_detector(cfg.model)
        batch = dict(image=jnp.zeros((2, 64, 96, 3)),
                     img_shape=jnp.full((2, 2), 64, jnp.int32),
                     gt_bboxes=jnp.zeros((2, 4, 4)),
                     gt_labels=jnp.zeros((2, 4), jnp.int32),
                     gt_valid=jnp.zeros((2, 4), bool),
                     domain=jnp.array([0, 1], jnp.int32))
        train = True
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: model.init(
        {'params': k, 'sampler': k, 'dropout': k}, batch, train=train))
    return jax.tree_util.tree_map(
        lambda a: np.broadcast_to(np.zeros((), a.dtype), a.shape),
        shapes['params'])


def _port_names(tree):
    """`{flax path: port name}` over a parameter tree, by the converter."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = tuple(k.key for k in path)
        name, _ = convert._convert_leaf('params', keys, leaf)
        out['.'.join(keys)] = name
    return out


@pytest.mark.parametrize('kind', ['swin_mask', 'r18_da'])
def test_paramwise_groups_and_frozen_mask_leaf_by_leaf(kind):
    """`paramwise_groups` on the port's names gives each leaf the
    (lr_mult, decay_mult) of the JAX package's `paramwise_labels`, under
    the Swin configs' keys and under bias/norm multipliers; the frozen
    mask freezes the same leaves. On Swin: `rel_bias` is decayed (the
    configs' `relative_position_bias_table` key matches no path) and
    `frozen_stages=1` freezes no leaf."""
    tree = _param_tree(kind)
    names = _port_names(tree)
    flat = {'.'.join(k.key for k in p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}
    for pw in (SWIN_PW, dict(bias_lr_mult=2.0, bias_decay_mult=0.5,
                             norm_decay_mult=0.0,
                             custom_keys={'rpn_head': dict(lr_mult=0.1)})):
        labels, mults = jts.paramwise_labels(tree, pw)
        jlab = {'.'.join(k.key for k in p): mults[lab] for p, lab in
                jax.tree_util.tree_flatten_with_path(labels)[0]}
        got = tts.paramwise_groups(names.values(), pw)
        for path, name in names.items():
            assert got[name] == jlab[path], (path, got[name], jlab[path])
    mask = jts.frozen_mask(tree, 1)
    jmask = {'.'.join(k.key for k in p): t for p, t in
             jax.tree_util.tree_flatten_with_path(mask)[0]}
    tmask = tts.frozen_mask(dict.fromkeys(names.values()), 1)
    assert all(tmask[n] == jmask[p] for p, n in names.items())
    if kind == 'swin_mask':
        assert all(jmask.values())
        groups = tts.paramwise_groups(names.values(), SWIN_PW)
        trunk = [n for n in names.values() if n.startswith('backbone.')]
        assert len(trunk) == 125
        assert sum(groups[n] == (1.0, 0.0) for n in trunk) == 48
        assert sum(groups[n] == (1.0, 1.0) for n in trunk) == 77
        assert groups['backbone.stage0.block0.attn.rel_bias'] == (1.0, 1.0)
    else:
        assert not all(jmask.values())
    assert set(flat) == set(names)


def _jax_run(tx, tree, grads):
    """`grads` applied in turn by the JAX optimizer, one jitted step."""
    import optax

    def step(g, state, params):
        if hasattr(tx, 'fused_apply'):
            return tx.fused_apply(g, state, params)
        updates, state = tx.update(g, state, params)
        return optax.apply_updates(params, updates), state

    step = jax.jit(step)
    state, params = tx.init(tree), tree
    for g in grads:
        params, state = step(g, state, params)
    return jax.device_get(params)


@functools.lru_cache(maxsize=2)
def _trunk_tree(kind):
    """A small parameter tree for the update checks, with the detectors'
    paths: the tiny Swin trunk under `backbone` (as in Mask R-CNN), or an
    R18 trunk of width 8 under `backbone/trunk` (as in the DA detectors),
    which the frozen mask reaches."""
    x = jnp.zeros((1, 64, 64, 3))
    if kind == 'swin':
        jm = jswin.SwinTransformer(**TINY_SWIN)
        return {'backbone': _swin_variables(jm, x, 0)['params']}
    jresnet = importlib.import_module(f'{JAX_PKG}.models.backbones.resnet')
    jm = jresnet.ResNet(depth=18, base_channels=8, frozen_stages=1)
    return {'backbone': {'trunk': _swin_variables(jm, x, 0)['params']}}


@pytest.mark.parametrize('opt_type', ['sgd', 'adam', 'adamw'])
@pytest.mark.parametrize('kind,frozen,pw', [
    ('swin', -1, None), ('swin', 1, 'swin'), ('r18', 1, 'bias_norm')])
def test_optimizers_match_make_optimizer(opt_type, kind, frozen, pw):
    """Five clipped steps of the port's optimizer against the JAX
    package's `make_optimizer` on the same parameters and gradients,
    through the warmup and a milestone, with paramwise groups and the
    frozen mask (on the R18 tree it freezes the stem and layer1: they stay
    as they were). Weight decay is the Swin configs' 0.05, but 1e-4 for
    Adam: its L2 term wd·p is added to the clipped gradient before the
    moments, and where it nearly cancels it (wd·p ≈ −s·g, a few elements
    in a million at 0.05) the first update is a ratio of two nearly
    cancelling f32 sums, which one ulp of the clip factor moves by ~1%
    on either side."""
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  _trunk_tree(kind))
    pw = {None: None, 'swin': SWIN_PW,
          'bias_norm': dict(bias_lr_mult=2.0, norm_decay_mult=0.0)}[pw]
    wd = 1e-4 if opt_type == 'adam' else 0.05
    spec = jts.OptimizerSpec(lr=0.01, weight_decay=wd, warmup_iters=3,
                             warmup_ratio=0.1, decay_steps=(4,),
                             grad_clip=2.0, opt_type=opt_type, paramwise=pw)
    rs = np.random.RandomState(1)
    grads = [jax.tree_util.tree_map(
        lambda a: (0.1 * rs.standard_normal(a.shape)).astype(np.float32),
        tree) for _ in range(5)]
    ref = _jax_run(jts.make_optimizer(spec, tree, frozen), tree, grads)
    params = _port_tensors(tree)
    tx = tts.make_optimizer(tts.OptimizerSpec(**spec._asdict()), params,
                            frozen)
    state = tx.init(params)
    start = {n: p.clone() for n, p in params.items()}
    for g in grads:
        params, state = tx.fused_apply(_port_tensors(g), state, params)
    assert state.count == 5
    want = _port_tensors(ref)
    for name, p in params.items():
        _close_scaled(p.numpy(), want[name].numpy(), 1e-5, name=name)
        if not tx.trainable[name]:
            assert torch.equal(p, start[name]), name
    assert all(tx.trainable.values()) == (kind == 'swin')


def _port_tensors(tree):
    """A JAX parameter tree as `{port name: tensor}`, by the converter."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name, value = convert._convert_leaf(
            'params', tuple(k.key for k in path), np.asarray(leaf))
        out[name] = torch.from_numpy(np.array(value, np.float32))
    return out


# ---- classification checkpoints ---------------------------------------------

def _official_swin_state_dict(rs, embed=16, depths=(2, 2, 2, 2),
                              heads=(1, 2, 2, 4), ws=7):
    """A seeded state dict in the official (microsoft) Swin layout, with
    the buffers, final norm and head the converters drop."""
    sd = {}

    def put(name, *shape):
        sd[name] = torch.from_numpy(
            rs.standard_normal(shape).astype(np.float32))

    put('patch_embed.proj.weight', embed, 3, 4, 4)
    put('patch_embed.proj.bias', embed)
    put('patch_embed.norm.weight', embed)
    put('patch_embed.norm.bias', embed)
    c = embed
    for i, depth in enumerate(depths):
        for j in range(depth):
            b = f'layers.{i}.blocks.{j}.'
            for n in ('norm1', 'norm2'):
                put(b + n + '.weight', c)
                put(b + n + '.bias', c)
            put(b + 'attn.relative_position_bias_table',
                (2 * ws - 1) ** 2, heads[i])
            sd[b + 'attn.relative_position_index'] = torch.zeros(
                ws * ws, ws * ws, dtype=torch.long)
            put(b + 'attn.qkv.weight', 3 * c, c)
            put(b + 'attn.qkv.bias', 3 * c)
            put(b + 'attn.proj.weight', c, c)
            put(b + 'attn.proj.bias', c)
            put(b + 'mlp.fc1.weight', 4 * c, c)
            put(b + 'mlp.fc1.bias', 4 * c)
            put(b + 'mlp.fc2.weight', c, 4 * c)
            put(b + 'mlp.fc2.bias', c)
        if i < len(depths) - 1:
            put(f'layers.{i}.downsample.norm.weight', 4 * c)
            put(f'layers.{i}.downsample.norm.bias', 4 * c)
            put(f'layers.{i}.downsample.reduction.weight', 2 * c, 4 * c)
            c *= 2
    put('norm.weight', c)
    put('norm.bias', c)
    put('head.weight', 10, c)
    put('head.bias', 10)
    return sd


def _torchvision_r18_state_dict(rs):
    from torch import nn
    res = importlib.import_module(f'{PORT_PKG}.models.backbones.resnet')
    sd = {}
    for name, t in res.ResNet(depth=18).state_dict().items():
        parts = name.split('.')
        leaf = {'scale': 'weight', 'mean': 'running_mean',
                'var': 'running_var'}.get(parts[-1], parts[-1])
        if len(parts) > 3 and parts[2].startswith('downsample_'):
            parts[2:3] = ['downsample', '0' if 'conv' in parts[2] else '1']
        sd['.'.join(parts[:-1] + [leaf])] = torch.from_numpy(
            rs.uniform(0.5, 1.5, tuple(t.shape)).astype(np.float32))
    sd['fc.weight'] = nn.Parameter(torch.zeros(10, 512)).data
    return sd


@pytest.mark.parametrize('layout', ['swin_mask', 'swin_da', 'r18_fpn'])
def test_load_pretrained_backbone_matches_jax(tmp_path, layout):
    """A seeded checkpoint written with `torch.save` (official Swin layout,
    wrapped in `model` as the published files are, into an FPN detector's
    trunk and into the DeepAlign-Swin trunk's `backbone.trunk`;
    torchvision R18 into an FPN detector's trunk) goes through the JAX
    package's `load_pretrained_backbone` and the port's: the port's trunk
    then holds exactly the JAX trunk's values, the rest is untouched, and
    the dropped keys warn nowhere."""
    jbuilder = importlib.import_module(f'{JAX_PKG}.models.builder')
    tbuilder = importlib.import_module(f'{PORT_PKG}.models.builder')
    rs = np.random.RandomState(11)
    k = jax.random.PRNGKey(0)
    if layout == 'swin_da':
        # the DA trunk (Swin-T and the DeepAlign taps) under `backbone`
        jmodel = jda.DAResNet(trunk_type='swin', out_indices=(2,),
                              taps=jda.VARIANT_TAPS['deep'])
        shapes = jax.eval_shape(lambda: jmodel.init(
            k, jnp.zeros((1, 64, 64, 3)), train=False))
        shapes = {c: {'backbone': t} for c, t in shapes.items()}
        port = torch.nn.Module()
        port.backbone = tda.DAResNet(trunk_type='swin', out_indices=(2,),
                                     taps=tda.VARIANT_TAPS['deep'])
        sd = _official_swin_state_dict(rs, embed=96, depths=(2, 2, 6, 2),
                                       heads=(3, 6, 12, 24))
    else:
        cfg = dict(type='MaskRCNN', num_classes=3, neck_channels=16)
        if layout == 'swin_mask':
            cfg['backbone_cfg'] = dict(type='SwinTransformer', **TINY_SWIN)
            sd = dict(model=_official_swin_state_dict(rs))
        else:
            cfg['backbone_depth'] = 18
            sd = _torchvision_r18_state_dict(rs)
        jmodel = jbuilder.build_detector(cfg)
        shapes = jax.eval_shape(lambda: jmodel.init(
            k, dict(image=jnp.zeros((1, 64, 64, 3)),
                    img_shape=jnp.full((1, 2), 64, jnp.int32)),
            train=False))
        port = tbuilder.build_detector(cfg, device='cpu')
    path = str(tmp_path / 'trunk.pth')
    torch.save(sd, path)
    jvars = fill_variables(shapes, np.random.RandomState(0))
    jloaded = jckpt.load_pretrained_backbone(jvars, path)
    assert convert.load_jax_variables(port, jvars) == []
    before = {n: t.clone() for n, t in port.state_dict().items()}
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        tckpt.load_pretrained_backbone(port, path)
    ref = convert.from_jax_variables(jloaded, port)[0]
    changed = 0
    for n, t in port.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), ref[n].numpy(), err_msg=n)
        changed += not torch.equal(t, before[n])
        if not n.startswith(('backbone.trunk.', 'backbone.patch',
                             'backbone.stage', 'backbone.merge',
                             'backbone.conv1', 'backbone.bn1',
                             'backbone.layer')):
            assert torch.equal(t, before[n]), n
    assert changed > 0


def test_pretrained_backbone_refusals_and_skips(tmp_path):
    """PVT and pycls RegNet checkpoints raise, naming the trunk; a leaf the
    trunk lacks, or of another shape, is skipped with a warning."""
    tbuilder = importlib.import_module(f'{PORT_PKG}.models.builder')
    port = tbuilder.build_detector(dict(
        type='MaskRCNN', num_classes=3, neck_channels=16,
        backbone_cfg=dict(type='SwinTransformer', **TINY_SWIN)),
        device='cpu')
    for keys, match in ((['patch_embed1.proj.weight'], 'PVT'),
                        (['stem.conv.weight'], 'RegNet')):
        path = str(tmp_path / f'{match}.pth')
        torch.save({k: torch.zeros(2) for k in keys}, path)
        with pytest.raises(NotImplementedError, match=match):
            tckpt.load_pretrained_backbone(port, path)
    sd = _official_swin_state_dict(np.random.RandomState(0))
    sd['layers.0.blocks.0.attn.qkv.weight'] = torch.zeros(5, 16)
    sd['layers.3.blocks.5.norm1.weight'] = torch.zeros(128)
    path = str(tmp_path / 'odd.pth')
    torch.save(sd, path)
    with pytest.warns(UserWarning) as record:
        tckpt.load_pretrained_backbone(port, path)
    text = ' '.join(str(r.message) for r in record)
    assert 'shape mismatch stage0/block0/attn/qkv/kernel' in text
    assert 'skip missing stage3/block5/norm1/scale' in text


# ---- data ------------------------------------------------------------------

@pytest.mark.parametrize('seed', [0, 1, 2, 3])
def test_photometric_distortion_matches_jax(seed):
    """Same image and `_rng` seed: the same float32 image, bit for bit,
    and the generator left in the same state."""
    img = np.random.RandomState(100 + seed).randint(
        0, 256, (37, 53, 3)).astype(np.uint8)
    rj, rt = np.random.RandomState(seed), np.random.RandomState(seed)
    ref = jtf.PhotoMetricDistortion()(dict(img=img.copy(), _rng=rj))['img']
    got = ttf.PhotoMetricDistortion()(
        dict(img=torch.from_numpy(img.copy()), _rng=rt))['img']
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert rj.randint(1 << 30) == rt.randint(1 << 30)


def test_swin_configs_resolve_as_in_jax():
    """The Swin-S fp16 config assigns `model` twice, so it builds a Swin-T:
    both loaders resolve it to the same dict; so for every Swin config."""
    for name in ('swin/mask_rcnn_swin-s-p4-w7_fpn_fp16_ms-crop-3x.py',
                 'swin/mask_rcnn_swin-t-p4-w7_fpn_fp16_ms-crop-3x.py',
                 'swin/mask_rcnn_swin-t-p4-w7_fpn_1x.py',
                 'da/deepalign_swin_t_c2f.py', 'da/synth_swin_deepalign.py'):
        path = str(ROOT / 'configs' / name)
        j = jconfig.Config.fromfile(path)
        t = tconfig.Config.fromfile(path)
        assert dict(t.model) == dict(j.model), name
        assert dict(t.optimizer) == dict(j.optimizer), name
    s = tconfig.Config.fromfile(
        str(ROOT / 'configs/swin/mask_rcnn_swin-s-p4-w7_fpn_fp16_ms-crop-3x.py'))
    assert dict(s.model) == {
        'type': 'MaskRCNN', 'num_classes': 80,
        'backbone_cfg': {'type': 'SwinTransformer'}, 'dtype': 'bfloat16'}
