"""The port's bf16 compute path, module by module, against the JAX
package's at `dtype=jnp.bfloat16` on the CPU: FrozenBN, the R18 trunk, the
FPN neck, the RPN head, the Shared2FC and FCN mask heads, the DA heads (in
f32 on a bf16 tap, as the JAX heads, which get no `dtype`, run), and the
plain RoIAlign at one level and on four levels (the JAX side's XLA form).

The same numpy inputs and weights (carried by `from_jax_variables`) go
through the JAX module at bf16, the JAX module at f32 and the port at
bf16. Each output meets both criteria (`_held`):

(a) max |port − JAX bf16| <= 2e-2 of max |JAX f32|;
(b) mean |port − JAX bf16| <= 0.5 x mean |JAX bf16 − JAX f32|: the port
    rounds where the JAX package rounds, so its distance from the JAX bf16
    result is well under bf16's own distance from f32 (on this CPU torch
    and XLA round a bf16 convolution's f32 sum differently in about one
    element in ten thousand, each time by one ulp).
"""

import importlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .torch_port_utils import JAX_PKG, PORT_PKG, edge_case_rois, \
    fill_variables

BF16 = jnp.bfloat16

jnorm = importlib.import_module(f'{JAX_PKG}.models.layers.norm')
jresnet = importlib.import_module(f'{JAX_PKG}.models.backbones.resnet')
jfpn = importlib.import_module(f'{JAX_PKG}.models.necks.fpn')
jrpn = importlib.import_module(f'{JAX_PKG}.models.dense_heads.rpn_head')
jbbox = importlib.import_module(f'{JAX_PKG}.models.roi_heads.bbox_head')
jmask = importlib.import_module(f'{JAX_PKG}.models.roi_heads.mask_head')
jheads = importlib.import_module(f'{JAX_PKG}.models.da.heads')
jra = importlib.import_module(f'{JAX_PKG}.ops.roi_align')
tnorm = importlib.import_module(f'{PORT_PKG}.models.layers.norm')
tprec = importlib.import_module(f'{PORT_PKG}.models.layers.precision')
tresnet = importlib.import_module(f'{PORT_PKG}.models.backbones.resnet')
tfpn = importlib.import_module(f'{PORT_PKG}.models.necks.fpn')
trpn = importlib.import_module(f'{PORT_PKG}.models.dense_heads.rpn_head')
tbbox = importlib.import_module(f'{PORT_PKG}.models.roi_heads.bbox_head')
tmask = importlib.import_module(f'{PORT_PKG}.models.roi_heads.mask_head')
theads = importlib.import_module(f'{PORT_PKG}.models.da.heads')
tra = importlib.import_module(f'{PORT_PKG}.ops.roi_align')
convert = importlib.import_module(f'{PORT_PKG}.utils.convert')


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def _held(got, ref_bf16, ref_f32, what=''):
    """Criteria (a) and (b) of the module docstring; returns the two
    ratios (each must be <= 1) for the log."""
    got, ref, f32 = _np(got), _np(ref_bf16), _np(ref_f32)
    assert got.shape == ref.shape == f32.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    dist = np.abs(got - ref)
    a = dist.max() / (2e-2 * np.abs(f32).max())
    b = dist.mean() / (0.5 * np.abs(ref - f32).mean())
    assert a <= 1, f'{what}: (a) max |port - JAX bf16| at {a:.3f} of its limit'
    assert b <= 1, f'{what}: (b) mean |port - JAX bf16| at {b:.3f} of its limit'
    return a, b


def _carry(jmod, tmod, seed, *args, **kw):
    """Seeded numpy variables for `jmod` (shapes from its init), loaded
    into `tmod`; returns them."""
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmod.init(
        {'params': k, 'dropout': k}, *args, **kw))
    variables = fill_variables(shapes, np.random.RandomState(seed))
    assert convert.load_jax_variables(tmod, variables) == []
    return variables


def _both(jmod_f32, jmod_bf16, variables, x, **kw):
    """The JAX module at f32 on `x` and at bf16 on `x` rounded to bf16."""
    f32 = jax.jit(lambda v, a: jmod_f32.apply(v, a, **kw))(
        variables, jnp.asarray(x))
    bf16 = jax.jit(lambda v, a: jmod_bf16.apply(v, a, **kw))(
        variables, jnp.asarray(x, BF16))
    return f32, bf16


def _bf16(x):
    """A numpy array as the bf16 tensor the JAX side rounds it to."""
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16()


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def test_compute_dtype_names_and_refusals():
    assert tprec.compute_dtype(None) is torch.float32
    assert tprec.compute_dtype('bfloat16') is torch.bfloat16
    assert tprec.compute_dtype(torch.bfloat16) is torch.bfloat16
    assert tprec.compute_dtype('float32') is torch.float32
    with pytest.raises(NotImplementedError, match='float16 compute'):
        tprec.compute_dtype('float16')
    with pytest.raises(ValueError, match='bfloat16'):
        tprec.compute_dtype('int8')


def test_f32_modules_pass_f32_through_and_upcast_bf16():
    """At float32 the convs and linears take an f32 input as it is (the
    f32 path is the one it was) and upcast a bf16 one, as flax promotes
    bf16 features and f32 parameters; at bf16 they compute and answer in
    bf16 with f32 parameters."""
    torch.manual_seed(0)
    conv, fc = tprec.Conv2d(4, 6, 3, padding=1), tprec.Linear(4, 3)
    ref_conv, ref_fc = torch.nn.Conv2d(4, 6, 3, padding=1), \
        torch.nn.Linear(4, 3)
    ref_conv.load_state_dict(conv.state_dict())
    ref_fc.load_state_dict(fc.state_dict())
    x = torch.randn(2, 4, 5, 5)
    assert torch.equal(conv(x), ref_conv(x))
    assert torch.equal(fc(x[..., 0, :4]), ref_fc(x[..., 0, :4]))
    assert conv(x.bfloat16()).dtype == torch.float32
    conv.compute_dtype = fc.compute_dtype = torch.bfloat16
    y = conv(x)
    assert y.dtype == torch.bfloat16 and conv.weight.dtype == torch.float32
    y.float().sum().backward()
    assert conv.weight.grad.dtype == torch.float32
    assert fc(x[..., 0, :4]).dtype == torch.bfloat16


def test_frozen_bn_bf16():
    """f32 multiplier and offset applied in bf16, rounded after the product
    and after the sum, as the JAX module does: equal element for element."""
    rs = np.random.RandomState(0)
    x = rs.standard_normal((2, 5, 7, 16)).astype(np.float32) * 3
    jm = jnorm.FrozenBatchNorm(16)
    tm = tnorm.FrozenBatchNorm(16)
    variables = _carry(jm, tm, 1, jnp.asarray(x))
    f32, bf16 = _both(jm, jm, variables, x)
    got = _nhwc(tm(_nchw(_bf16(x))))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(bf16))
    _held(got, bf16, f32, 'FrozenBN')


def test_r18_trunk_bf16_all_stages():
    rs = np.random.RandomState(18)
    x = rs.standard_normal((2, 64, 96, 3)).astype(np.float32)
    geom = dict(depth=18, strides=(1, 2, 2, 1), dilations=(1, 1, 1, 2),
                out_indices=(3,))
    tm = tresnet.ResNet(dtype=torch.bfloat16, **geom).eval()
    jm = jresnet.ResNet(**geom)
    variables = _carry(jm, tm, 18, jnp.asarray(x), return_all_stages=True)
    f32, bf16 = _both(jm, jm.clone(dtype=BF16), variables, x,
                      return_all_stages=True)
    with torch.no_grad():
        got = tm(_nchw(_bf16(x)), return_all_stages=True)
    for i, (g, r, f) in enumerate(zip(got, bf16, f32)):
        assert g.dtype == torch.bfloat16 and r.dtype == BF16
        _held(_nhwc(g), r, f, f'C{i + 2}')


def test_fpn_neck_bf16():
    rs = np.random.RandomState(5)
    chans, sizes = (16, 24, 32, 40), ((32, 48), (16, 24), (8, 12), (4, 6))
    xs = [rs.standard_normal((2, h, w, c)).astype(np.float32)
          for c, (h, w) in zip(chans, sizes)]
    jm = jfpn.FPN(in_channels=chans, out_channels=32, num_outs=5)
    tm = tfpn.FPN(in_channels=chans, out_channels=32, num_outs=5,
                  dtype=torch.bfloat16)
    variables = _carry(jm, tm, 6, tuple(jnp.asarray(x) for x in xs))
    jb = jm.clone(dtype=BF16)
    f32 = jm.apply(variables, tuple(jnp.asarray(x) for x in xs))
    bf16 = jb.apply(variables, tuple(jnp.asarray(x, BF16) for x in xs))
    with torch.no_grad():
        got = tm([_nchw(_bf16(x)) for x in xs])
    assert len(got) == 5
    for i, (g, r, f) in enumerate(zip(got, bf16, f32)):
        assert g.dtype == torch.bfloat16
        _held(_nhwc(g), r, f, f'P{i + 2}')


def test_rpn_head_bf16():
    rs = np.random.RandomState(7)
    x = rs.standard_normal((2, 6, 9, 32)).astype(np.float32)
    jm = jrpn.RPNHead(feat_channels=64, num_anchors=6)
    tm = trpn.RPNHead(in_channels=32, feat_channels=64, num_anchors=6,
                      dtype=torch.bfloat16)
    variables = _carry(jm, tm, 8, jnp.asarray(x))
    (fc, fr), (bc, br) = _both(jm, jm.clone(dtype=BF16), variables, x)
    with torch.no_grad():
        gc, gr = tm(_nchw(_bf16(x)))
    assert gc.dtype == gr.dtype == torch.bfloat16
    _held(gc, bc, fc, 'RPN cls')
    _held(gr, br, fr, 'RPN reg')


def test_shared2fc_head_bf16():
    rs = np.random.RandomState(9)
    x = rs.standard_normal((2, 24, 7, 7, 16)).astype(np.float32)
    jm = jbbox.Shared2FCBBoxHead(num_classes=3, fc_out_channels=64)
    tm = tbbox.Shared2FCBBoxHead(num_classes=3, in_channels=16,
                                 fc_out_channels=64, dtype=torch.bfloat16)
    variables = _carry(jm, tm, 10, jnp.asarray(x))
    f32, bf16 = _both(jm, jm.clone(dtype=BF16), variables, x)
    with torch.no_grad():
        got = tm(_bf16(x))
    for name, g, r, f in zip(('cls', 'reg', 'shared'), got, bf16, f32):
        assert g.dtype == torch.bfloat16
        _held(g, r, f, f'Shared2FC {name}')


@pytest.mark.parametrize('normed', [False, True])
def test_fcn_mask_head_bf16(normed):
    rs = np.random.RandomState(11 + normed)
    x = rs.standard_normal((2, 6, 7, 7, 12)).astype(np.float32)
    jm = jmask.FCNMaskHead(num_classes=3, num_convs=2, feat_channels=16,
                           normed_predictor=normed)
    tm = tmask.FCNMaskHead(num_classes=3, num_convs=2, in_channels=12,
                           feat_channels=16, normed_predictor=normed,
                           dtype=torch.bfloat16)
    variables = _carry(jm, tm, 12, jnp.asarray(x))
    f32, bf16 = _both(jm, jm.clone(dtype=BF16), variables, x)
    with torch.no_grad():
        got = tm(_bf16(x))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == bf16.shape
    _held(got, bf16, f32, 'mask logits')


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, fnn.Dropout) and \
            context.method_name == '__call__':
        return args[0]
    return next_fun(*args, **kwargs)


DA_HEADS = {
    'global_cbam': (lambda c: jheads.GlobalAlignmentHead(c, 'cbam'),
                    lambda c: theads.GlobalAlignmentHead(c, 'cbam'),
                    (2, 8, 12), False),
    'global_mhsa': (lambda c: jheads.GlobalAlignmentHead(c, 'mhsa'),
                    lambda c: theads.GlobalAlignmentHead(c, 'mhsa',
                                                         map_hw=(4, 6)),
                    (2, 8, 12), False),
    'pixel': (lambda c: jheads.PixelAlignmentHead(c),
              lambda c: theads.PixelAlignmentHead(c), (2, 6, 9), True),
    'srm': (lambda c: jheads.SRMHead(c), lambda c: theads.SRMHead(c),
            (2, 6, 9), False),
    'image': (lambda c: jheads.ImageAlignmentHead(c),
              lambda c: theads.ImageAlignmentHead(c), (2, 6, 9), True),
}


@pytest.mark.parametrize('kind', sorted(DA_HEADS))
def test_da_heads_run_f32_on_a_bf16_tap(kind):
    """A DA head on a bf16 tap: f32 output, the input gradient back in
    bf16 through the GRL. Train mode (batch statistics) with dropout off,
    forward and input gradient held to the JAX head on the same bf16 tap
    by criteria (a) and (b); the JAX head on the f32 tap is the f32
    reference."""
    make_j, make_t, (b, h, w), map_out = DA_HEADS[kind]
    c = 32
    rs = np.random.RandomState(len(kind))
    x = rs.standard_normal((b, h, w, c)).astype(np.float32)
    jm, tm = make_j(c), make_t(c)
    variables = _carry(jm, tm, 13, jnp.asarray(x), train=True)
    stats = variables.get('batch_stats', {})

    def f(a):
        out, _ = jm.apply({'params': variables['params'],
                           'batch_stats': stats}, a, train=True,
                          mutable=['batch_stats'])
        return out

    with fnn.intercept_methods(_no_dropout):
        cot = rs.standard_normal(jax.eval_shape(f, jnp.asarray(x)).shape)
        f_out, f_vjp = jax.vjp(f, jnp.asarray(x))
        b_out, b_vjp = jax.vjp(f, jnp.asarray(x, BF16))
        f_grad = f_vjp(jnp.asarray(cot, f_out.dtype))[0]
        b_grad = b_vjp(jnp.asarray(cot, b_out.dtype))[0]
    assert b_out.dtype == jnp.float32 and b_grad.dtype == BF16
    tm.train()
    for m in tm.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    xt = _nchw(_bf16(x)).detach().requires_grad_()
    out = tm(xt)
    assert out.dtype == torch.float32
    (out * torch.from_numpy(cot).float()).sum().backward()
    assert xt.grad.dtype == torch.bfloat16
    _held(out, b_out, f_out, f'{kind} logits')
    _held(_nhwc(xt.grad), b_grad, f_grad, f'{kind} tap gradient')


@pytest.mark.parametrize('nonlocal_', [True, False])
def test_instance_head_runs_f32_on_bf16_features(nonlocal_):
    rs = np.random.RandomState(14 + nonlocal_)
    x = rs.standard_normal((24, 64)).astype(np.float32)
    jm = jheads.InstanceAlignmentHead(feat_dim=64, use_nonlocal=nonlocal_)
    tm = theads.InstanceAlignmentHead(feat_dim=64, use_nonlocal=nonlocal_)
    variables = _carry(jm, tm, 15, jnp.asarray(x), train=False)
    f32 = jm.apply(variables, jnp.asarray(x), train=False)
    bf16 = jm.apply(variables, jnp.asarray(x, BF16), train=False)
    assert bf16.dtype == jnp.float32
    with torch.no_grad():
        got = tm.eval()(_bf16(x))
    assert got.dtype == torch.float32
    _held(got, bf16, f32, 'instance logits')


def test_plain_roi_align_bf16_one_level():
    rs = np.random.RandomState(16)
    feats = rs.standard_normal((2, 12, 18, 16)).astype(np.float32)
    rois = edge_case_rois(rs, 2, 40, 12, 18)
    f32, bf16 = (jra.batched_roi_align(jnp.asarray(feats, dt),
                                       jnp.asarray(rois), 1 / 16.,
                                       flatten=True)
                 for dt in (jnp.float32, BF16))
    got = tra.batched_roi_align(_bf16(feats), torch.from_numpy(rois),
                                1 / 16., flatten=True)
    assert got.dtype == torch.bfloat16
    _held(got, bf16, f32, 'RoIAlign, one level')


@pytest.mark.parametrize('out_size', [7, 14])
def test_plain_roi_align_bf16_four_levels(out_size):
    rs = np.random.RandomState(17 + out_size)
    sizes = ((32, 48), (16, 24), (8, 12), (4, 6))
    feats = [rs.standard_normal((2, h, w, 8)).astype(np.float32)
             for h, w in sizes]
    # sqrt(area) 8..700 px on the 128x192 canvas: every level gets RoIs,
    # some crossing the border
    side = np.exp(rs.uniform(np.log(8), np.log(700), (2, 48)))
    xy = rs.uniform(0, 1, (2, 48, 2)) * np.array([192, 128]) - \
        side[..., None] / 2
    rois = np.concatenate([xy, xy + side[..., None]], -1).astype(np.float32)
    f32, bf16 = (jra.batched_roi_align_fpn(
        tuple(jnp.asarray(f, dt) for f in feats), jnp.asarray(rois),
        (4, 8, 16, 32), out_size=out_size) for dt in (jnp.float32, BF16))
    got = tra.batched_roi_align_fpn([_bf16(f) for f in feats],
                                    torch.from_numpy(rois),
                                    out_size=out_size)
    levels = tra.roi_levels(torch.from_numpy(rois), 4)
    assert len(set(levels.flatten().tolist())) == 4
    assert got.dtype == torch.bfloat16
    _held(got, bf16, f32, f'RoIAlign, four levels, o={out_size}')
