"""Port's FrozenBN and ResNet trunks vs the JAX package's, with the same
random weights carried across by `from_jax_variables`. Tolerance 1e-4 of
the output's scale: convolutions sum thousands of products in another
order on each side."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .torch_port_utils import JAX_PKG, PORT_PKG, fill_variables

jresnet = importlib.import_module(f'{JAX_PKG}.models.backbones.resnet')
jnorm = importlib.import_module(f'{JAX_PKG}.models.layers.norm')
jda = importlib.import_module(f'{JAX_PKG}.models.backbones.da_resnet')
tresnet = importlib.import_module(f'{PORT_PKG}.models.backbones.resnet')
tnorm = importlib.import_module(f'{PORT_PKG}.models.layers.norm')
tda = importlib.import_module(f'{PORT_PKG}.models.backbones.da_resnet')
convert = importlib.import_module(f'{PORT_PKG}.utils.convert')


def _carry(jmodel, tmodel, x, seed, **apply_kw):
    """Random weights into both models; returns (jax out, torch module)."""
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), x,
                                                **apply_kw))
    variables = fill_variables(shapes, np.random.RandomState(seed))
    unmapped = convert.load_jax_variables(tmodel, variables)
    assert unmapped == []
    return variables


def _close(got, ref, tol=1e-4):
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale)


def test_frozen_bn():
    rs = np.random.RandomState(0)
    x = rs.standard_normal((2, 5, 7, 6)).astype(np.float32)
    jm = jnorm.FrozenBatchNorm(6)
    tm = tnorm.FrozenBatchNorm(6)
    variables = _carry(jm, tm, jnp.asarray(x), 1)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x)))
    got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize('depth,hw', [(18, (70, 90)), (50, (64, 64))])
def test_dc5_trunk_all_stages(depth, hw):
    rs = np.random.RandomState(depth)
    x = rs.standard_normal((2,) + hw + (3,)).astype(np.float32)
    geom = dict(depth=depth, strides=(1, 2, 2, 1), dilations=(1, 1, 1, 2),
                out_indices=(3,))
    jm = jresnet.ResNet(**geom)
    tm = tresnet.ResNet(**geom).eval()
    variables = _carry(jm, tm, jnp.asarray(x), depth,
                       return_all_stages=True)
    refs = jax.jit(lambda v, a: jm.apply(v, a, return_all_stages=True))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        gots = tm(torch.from_numpy(x).permute(0, 3, 1, 2),
                  return_all_stages=True)
    assert len(gots) == 4
    for ref, got in zip(refs, gots):
        got = got.permute(0, 2, 3, 1).numpy()
        assert got.shape == ref.shape
        _close(got, np.asarray(ref))


def test_da_resnet_inference_matches_and_heads_raise():
    rs = np.random.RandomState(3)
    x = rs.standard_normal((1, 48, 64, 3)).astype(np.float32)
    jm = jda.DAResNet(depth=18)
    tm = tda.DAResNet(depth=18).eval()
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.asarray(x), train=False))
    variables = fill_variables(shapes, rs)
    # the 'daf' alignment heads are ported: every leaf maps
    assert convert.load_jax_variables(tm, variables) == []
    (ref,), _ = jm.apply(variables, jnp.asarray(x), train=False,
                         with_da=False)
    with torch.no_grad():
        (got,), da = tm(torch.from_numpy(x).permute(0, 3, 1, 2),
                        with_da=False)
    assert da == {}
    _close(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref))
    # the heads of the other variants (MAF's SRM) run now
    maf = tda.DAResNet(depth=18, taps=tda.VARIANT_TAPS['maf'])
    with torch.no_grad():
        _, da = maf(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert {k: tuple(v.shape) for k, v in da.items()} == {
        'srm_s1_0': (1, 2), 'srm_s2_1': (1, 2), 'srm_s3_2': (1, 2)}
    # and so does the Swin trunk: Swin-T tapped at stage 2, as the JAX one
    jswin = jda.DAResNet(trunk_type='swin', out_indices=(2,))
    tswin = tda.DAResNet(trunk_type='swin', out_indices=(2,)).eval()
    shapes = jax.eval_shape(lambda: jswin.init(jax.random.PRNGKey(0),
                                               jnp.asarray(x), train=False))
    variables = fill_variables(shapes, rs)
    assert convert.load_jax_variables(tswin, variables) == []
    (ref,), _ = jswin.apply(variables, jnp.asarray(x), train=False,
                            with_da=False)
    with torch.no_grad():
        (got,), _ = tswin(torch.from_numpy(x).permute(0, 3, 1, 2),
                          with_da=False)
    assert got.shape[1] == 384
    _close(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref))
