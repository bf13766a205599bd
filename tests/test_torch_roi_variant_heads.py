"""The RoI-head variants' heads against the JAX modules, alone, at f32 and
bf16: `DoubleBBoxHead`, `GridHead`, `MaskIoUHead` and `PointHead`, from
the same seeded weights (converted by `load_jax_variables`) on seeded
inputs of a few RoIs.

Tolerances: at f32 each output within 1e-4 of its scale (the convs sum in
another order); at bf16 within 2e-2 of the f32 output's scale, the
criterion `test_torch_bf16.py` holds the other modules to.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .torch_port_utils import JAX_PKG, PORT_PKG, fill_variables

jvariants = importlib.import_module(
    f'{JAX_PKG}.models.detectors.roi_variants')
tvariants = importlib.import_module(
    f'{PORT_PKG}.models.detectors.roi_variants')
convert = importlib.import_module(f'{PORT_PKG}.utils.convert')

K = 5


def _inputs(name, rs):
    """The head's JAX inputs (B=2, S=3 RoIs) as numpy arrays."""
    if name == 'DoubleBBoxHead':
        return [rs.standard_normal((2, 3, 7, 7, 16))]
    if name == 'GridHead':
        return [rs.standard_normal((2, 3, 14, 14, 16))]
    if name == 'MaskIoUHead':
        return [rs.standard_normal((2, 3, 14, 14, 16)),
                rs.uniform(0, 1, (2, 3, 28, 28, 1))]
    return [rs.standard_normal((2, 3, 10, 16)),
            rs.standard_normal((2, 3, 10, K))]


def _modules(name, dtype):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    if name == 'DoubleBBoxHead':
        return (jvariants.DoubleBBoxHead(num_classes=K, conv_out=32,
                                         fc_out=24, dtype=jdt),
                tvariants.DoubleBBoxHead(num_classes=K, in_channels=16,
                                         conv_out=32, fc_out=24,
                                         dtype=dtype))
    if name == 'GridHead':
        return (jvariants.GridHead(conv_out=16, dtype=jdt),
                tvariants.GridHead(in_channels=16, conv_out=16, dtype=dtype))
    if name == 'MaskIoUHead':
        return (jvariants.MaskIoUHead(num_classes=K, dtype=jdt),
                tvariants.MaskIoUHead(num_classes=K, in_channels=16,
                                      dtype=dtype))
    return (jvariants.PointHead(num_classes=K, dtype=jdt),
            tvariants.PointHead(num_classes=K, in_channels=16, dtype=dtype))


def _outputs(name, dtype):
    rs = np.random.RandomState(0)
    xs = [x.astype(np.float32) for x in _inputs(name, rs)]
    jm, tm = _modules(name, dtype)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            *map(jnp.asarray, xs)))
    variables = fill_variables(shapes, np.random.RandomState(1))
    assert convert.load_jax_variables(tm, variables) == []
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = jm.apply(variables, *[jnp.asarray(x, jdt) for x in xs])
    with torch.no_grad():
        got = tm(*[torch.from_numpy(x).to(dtype) for x in xs])
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    return ([np.asarray(r, np.float32) for r in ref],
            [g.float().numpy() for g in got])


HEADS = ['DoubleBBoxHead', 'GridHead', 'MaskIoUHead', 'PointHead']


@pytest.mark.parametrize('name', HEADS)
def test_head_matches_jax_at_f32(name):
    ref, got = _outputs(name, torch.float32)
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(r).max()))


@pytest.mark.parametrize('name', HEADS)
def test_head_matches_jax_at_bf16(name):
    f32, _ = _outputs(name, torch.float32)
    ref, got = _outputs(name, torch.bfloat16)
    for r, g, s in zip(ref, got, f32):
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=2e-2 * max(1.0, np.abs(s).max()))
