"""The port's DA modules against the JAX package's: GRL, the live
BatchNorm, CBAM and the non-local block, the three alignment heads, the
k-means grouping and the DA losses.

Weights and inputs come from numpy seeds and are carried across by
`from_jax_variables`. Modules run in train mode on both sides; dropout is
neutralised on the JAX side with `flax.linen.intercept_methods` and by
`p = 0` on the port's `nn.Dropout`s. Outputs, input and parameter
gradients and the updated batch statistics agree within 1e-4 of their
scale: convolutions and batch means sum in another order on each side, and
BatchNorm divides by batch deviations of a few samples.
"""

import importlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .torch_port_utils import JAX_PKG, PORT_PKG, fill_variables

jgrl = importlib.import_module(f'{JAX_PKG}.models.layers.grl')
jatt = importlib.import_module(f'{JAX_PKG}.models.layers.attention')
jheads = importlib.import_module(f'{JAX_PKG}.models.da.heads')
jcluster = importlib.import_module(f'{JAX_PKG}.models.da.cluster')
jdal = importlib.import_module(f'{JAX_PKG}.models.da.losses')
tgrl = importlib.import_module(f'{PORT_PKG}.models.layers.grl')
tnorm = importlib.import_module(f'{PORT_PKG}.models.layers.norm')
tatt = importlib.import_module(f'{PORT_PKG}.models.layers.attention')
theads = importlib.import_module(f'{PORT_PKG}.models.da.heads')
tcluster = importlib.import_module(f'{PORT_PKG}.models.da.cluster')
tdal = importlib.import_module(f'{PORT_PKG}.models.da.losses')
convert = importlib.import_module(f'{PORT_PKG}.utils.convert')


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, tol=1e-4, floor=1e-3):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(floor, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, fnn.Dropout) and \
            context.method_name == '__call__':
        return args[0]
    return next_fun(*args, **kwargs)


def _nchw(x):
    return x.permute(0, 3, 1, 2) if x.dim() == 4 else x


def _nhwc(x):
    return x.permute(0, 2, 3, 1) if x.dim() == 4 else x


def _train_both(jmod, tmod, x, seed, map_in=True, map_out=False,
                **apply_kw):
    """One train-mode forward and backward of sum(out * R) on both sides
    from the same variables; checks outputs, input and parameter gradients
    and the updated batch statistics. `map_in`/`map_out`: the port module
    takes / returns NCHW where the JAX one has NHWC. A bias in front of a
    BatchNorm has a true gradient of 0, so parameter gradients are held to
    1e-4 of at least 0.1."""
    rs = np.random.RandomState(seed)
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmod.init(
        {'params': k, 'dropout': k}, jnp.asarray(x), **apply_kw))
    variables = fill_variables(shapes, rs)
    assert convert.load_jax_variables(tmod, variables) == []
    stats = variables.get('batch_stats', {})

    def f(params, xx):
        out, new = jmod.apply({'params': params, 'batch_stats': stats}, xx,
                              mutable=['batch_stats'], **apply_kw)
        return out, new

    with fnn.intercept_methods(_no_dropout):
        ref, new_vars = f(variables['params'], jnp.asarray(x))
        cot = rs.standard_normal(ref.shape).astype(np.float32)
        gp, gx = jax.grad(lambda p, xx: jnp.sum(f(p, xx)[0] * cot),
                          argnums=(0, 1))(variables['params'],
                                          jnp.asarray(x))
    tmod.train()
    for m in tmod.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    xt = _t(x).requires_grad_()
    got = tmod(_nchw(xt) if map_in else xt)
    got = _nhwc(got) if map_out else got
    (got * _t(cot)).sum().backward()
    _close(got.detach().numpy(), ref)
    _close(xt.grad.numpy(), gx)
    grads, unmapped = convert.from_jax_variables({'params': gp}, tmod)
    assert unmapped == []
    for name, p in tmod.named_parameters():
        _close(p.grad.numpy(), grads[name].numpy(), floor=0.1)
    new_stats, _ = convert.from_jax_variables(
        {'batch_stats': new_vars.get('batch_stats', {})}, tmod)
    buffers = dict(tmod.named_buffers())
    assert set(new_stats) == set(buffers)
    for name, b in buffers.items():
        _close(b.numpy(), new_stats[name].numpy())
    return new_stats


def test_gradient_reverse_and_scalar():
    x = np.random.RandomState(0).standard_normal((3, 4)).astype(np.float32)
    for weight in (-1.0, 0.3):
        gj = jax.grad(lambda a: jnp.sum(
            jgrl.gradient_scalar(a, weight) ** 2))(jnp.asarray(x))
        xt = _t(x).requires_grad_()
        out = tgrl.gradient_scalar(xt, weight)
        np.testing.assert_array_equal(out.detach().numpy(), x)
        (out ** 2).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), gj, rtol=1e-6)
    xt = _t(x).requires_grad_()
    tgrl.gradient_reverse(xt).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), -np.ones_like(x))


def test_batch_norm_train_and_eval():
    x = (3 + 2 * np.random.RandomState(1).standard_normal((4, 5, 6, 8))
         ).astype(np.float32)
    stats = _train_both(fnn.BatchNorm(use_running_average=False,
                                      momentum=0.99, epsilon=1e-5),
                        tnorm.BatchNorm(8), x, 2, map_out=True)
    assert set(stats) == {'mean', 'var'}
    # eval: normalise with the running statistics, leave them alone
    bn = tnorm.BatchNorm(8)
    bn.mean.fill_(0.5)
    bn.var.fill_(4.0)
    bn.eval()
    got = bn(_nchw(_t(x)))
    np.testing.assert_allclose(_nhwc(got).detach().numpy(),
                               (x - 0.5) / np.sqrt(4.0 + 1e-5), rtol=1e-5)
    assert float(bn.mean[0]) == 0.5 and float(bn.var[0]) == 4.0


def test_cbam():
    x = np.random.RandomState(3).standard_normal((2, 5, 7, 32)).astype(
        np.float32)
    _train_both(jatt.CBAM(32), tatt.CBAM(32), x, 4, map_out=True)


def test_nonlocal_block():
    x = np.random.RandomState(5).standard_normal((12, 16)).astype(np.float32)
    _train_both(jatt.NonLocalBlock(16), tatt.NonLocalBlock(16), x, 6,
                map_in=False)


@pytest.mark.parametrize('hw', [(8, 12), (5, 7)])
def test_global_alignment_head(hw):
    x = np.random.RandomState(7).standard_normal((2,) + hw + (64,)).astype(
        np.float32)
    _train_both(jheads.GlobalAlignmentHead(64),
                theads.GlobalAlignmentHead(64), x, 8)


def test_pixel_alignment_head():
    x = np.random.RandomState(9).standard_normal((2, 6, 9, 24)).astype(
        np.float32)
    _train_both(jheads.PixelAlignmentHead(24),
                theads.PixelAlignmentHead(24), x, 10)


@pytest.mark.parametrize('use_nonlocal', [True, False])
def test_instance_alignment_head(use_nonlocal):
    x = np.random.RandomState(11).standard_normal((10, 32)).astype(
        np.float32)
    _train_both(jheads.InstanceAlignmentHead(32, use_nonlocal=use_nonlocal),
                theads.InstanceAlignmentHead(32, use_nonlocal=use_nonlocal),
                x, 12, map_in=False)


def test_dropout_keeps_half_and_doubles():
    """Flax's rate-0.5 dropout: each value kept with probability 0.5 and
    then scaled by 2. 200k draws put the kept share within 0.5 ± 0.005
    (over 4 standard deviations)."""
    head = theads.InstanceAlignmentHead(32).train()
    x = torch.ones(200_000)
    torch.manual_seed(0)
    y = head.drop(x)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.5) < 0.005
    assert torch.all(y[kept] == 2.0)
    head.eval()
    assert torch.equal(head.drop(x), x)


# ---- k-means and DA losses ------------------------------------------------

def _bucket(seed, n, d, n_valid):
    rs = np.random.RandomState(seed)
    feats = np.maximum(rs.standard_normal((n, d)), 0).astype(np.float32)
    mask = np.zeros(n, bool)
    mask[rs.permutation(n)[:n_valid]] = True
    scores = rs.uniform(size=n).astype(np.float32)
    return feats, mask, scores


@pytest.mark.parametrize('n_valid', [30, 4, 0])   # k-means, padded, empty
def test_group_representatives_and_kmeans(n_valid):
    feats, mask, scores = _bucket(n_valid, 40, 8, n_valid)
    k = 6
    cot = np.random.RandomState(1).standard_normal((k, 8)).astype(np.float32)

    def jf(f):
        reps, valid = jcluster.group_representatives(
            f, jnp.asarray(mask), jnp.asarray(scores), k)
        return jnp.sum(reps * cot), (reps, valid)

    (_, (reps, valid)), gj = jax.value_and_grad(jf, has_aux=True)(
        jnp.asarray(feats))
    ft = _t(feats).requires_grad_()
    treps, tvalid = tcluster.group_representatives(ft, _t(mask), _t(scores),
                                                   k)
    (treps * _t(cot)).sum().backward()
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(valid))
    _close(treps.detach().numpy(), reps, 1e-5)
    _close(ft.grad.numpy(), gj, 1e-5)
    cents = jcluster.masked_kmeans(jnp.asarray(feats), jnp.asarray(mask), k)
    _close(tcluster.masked_kmeans(_t(feats), _t(mask), k).numpy(), cents,
           1e-5)


def test_global_and_patch_losses():
    rs = np.random.RandomState(13)
    logits = rs.standard_normal((2, 2)).astype(np.float32)
    domain = np.array([0, 1], np.int32)
    lm = rs.standard_normal((2, 5, 6, 1)).astype(np.float32)
    for quirk in (False, True):
        jv, jg = jax.value_and_grad(lambda a: jdal.global_alignment_loss(
            a, jnp.asarray(domain), quirk))(jnp.asarray(logits))
        lt = _t(logits).requires_grad_()
        tv = tdal.global_alignment_loss(lt, _t(domain), quirk)
        _close(tv.item(), float(jv), 1e-6)
        assert tv.requires_grad != quirk
        if not quirk:
            tv.backward()
            _close(lt.grad.numpy(), jg, 1e-6)
        jv, jg = jax.value_and_grad(lambda m: jdal.patch_ls_loss(
            m, jnp.asarray(domain), quirk))(jnp.asarray(lm))
        mt = _t(lm).requires_grad_()
        tv = tdal.patch_ls_loss(mt, _t(domain), quirk)
        tv.backward()
        _close(tv.item(), float(jv), 1e-6)
        _close(mt.grad.numpy(), jg, 1e-6)


@pytest.mark.parametrize('quirk_detach', [False, True])
def test_grouped_instance_loss(quirk_detach):
    """Through the two instance heads (non-local, dropout off): the loss
    and the gradient that reaches the RoI features."""
    rs = np.random.RandomState(14)
    b, s, d, k = 2, 24, 16, 4
    feats = np.maximum(rs.standard_normal((b, s, d)), 0).astype(np.float32)
    cls = (2 * rs.standard_normal((b, s, 4))).astype(np.float32)
    valid = rs.uniform(size=(b, s)) < 0.8
    domain = np.array([0, 1], np.int32)
    heads, tmods = [], []
    for seed in (15, 16):
        jm = jheads.InstanceAlignmentHead(d)
        tm = theads.InstanceAlignmentHead(d).train()
        tm.drop.p = 0.0
        v = fill_variables(jax.eval_shape(lambda m=jm: m.init(
            {'params': jax.random.PRNGKey(0)}, jnp.zeros((2 * k, d)))),
            np.random.RandomState(seed))
        convert.load_jax_variables(tm, v)
        heads.append(lambda r, m=jm, v=v: m.apply(v, r))
        tmods.append(tm)

    def jf(f):
        return jdal.grouped_instance_loss(
            heads[0], heads[1], f, jnp.asarray(cls), jnp.asarray(valid),
            jnp.asarray(domain), k=k, quirk_detach=quirk_detach)

    with fnn.intercept_methods(_no_dropout):
        jv, jg = jax.value_and_grad(jf)(jnp.asarray(feats))
    ft = _t(feats).requires_grad_()
    tv = tdal.grouped_instance_loss(tmods[0], tmods[1], ft, _t(cls),
                                    _t(valid), _t(domain), k=k,
                                    quirk_detach=quirk_detach)
    _close(tv.item(), float(jv), 1e-5)
    if quirk_detach:
        assert not tv.requires_grad
    else:
        tv.backward()
        _close(ft.grad.numpy(), jg, 1e-4)
