"""The port's deformable convolution (`ops/deform_conv.py`) against the JAX
package's `ops/deform_conv.py` on the same seeded inputs: the output and
the gradients with respect to the input, the offsets, the weight and the
v2 mask, in float32 within 1e-5 of each tensor's scale and in bfloat16
within 2e-2; and at zero offsets the plain 3x3 convolution.

Offsets reach past the map's border and land on whole pixels too (where
the sample's floor has no gradient and the offsets get the bilinear
weights' own)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from .torch_port_utils import JAX_PKG, PORT_PKG

jdc = importlib.import_module(f'{JAX_PKG}.ops.deform_conv')
tdc = importlib.import_module(f'{PORT_PKG}.ops.deform_conv')

B, H, W, C, CO = 2, 9, 11, 5, 4


def _inputs(seed, k=3, stride=1, dilation=1, padding=None):
    rs = np.random.RandomState(seed)
    pad = (dilation * (k - 1)) // 2 if padding is None else padding
    ho = (H + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    wo = (W + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    off = rs.normal(0.0, 2.0, (B, ho, wo, 2 * k * k))
    # a quarter of the offsets on whole pixels, some far past the border
    whole = rs.uniform(size=off.shape) < 0.25
    off[whole] = np.round(off[whole])
    off[0, 0, 0, :4] = (-7.0, 13.0, 0.0, -12.0)
    return dict(x=rs.standard_normal((B, H, W, C)),
                offsets=off,
                weight=rs.standard_normal((k, k, C, CO)) / np.sqrt(k * k * C),
                mask=rs.uniform(0.0, 1.0, (B, ho, wo, k * k)),
                cot=rs.standard_normal((B, ho, wo, CO)))


def _jax(inp, dtype, with_mask, **kw):
    args = [jnp.asarray(inp[k], dtype) for k in
            ('x', 'offsets', 'weight', 'mask')]

    def f(x, offsets, weight, mask):
        out = jdc.batched_deform_conv2d(x, offsets, weight,
                                        mask=mask if with_mask else None,
                                        **kw)
        return jnp.sum(out.astype(jnp.float32) * inp['cot']), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2, 3), has_aux=True))(*args)
    return [np.asarray(v, np.float32) for v in (out,) + grads]


def _port(inp, dtype, with_mask, **kw):
    args = {k: torch.tensor(inp[k], dtype=dtype, requires_grad=True)
            for k in ('x', 'offsets', 'weight', 'mask')}
    out = tdc.batched_deform_conv2d(
        args['x'], args['offsets'], args['weight'],
        mask=args['mask'] if with_mask else None, **kw)
    (out.float() * torch.tensor(inp['cot'], dtype=torch.float32)).sum(
        ).backward()
    grads = [args[k].grad for k in ('x', 'offsets', 'weight', 'mask')]
    return [out.detach().float().numpy()] + [
        np.zeros(inp['mask'].shape, np.float32) if g is None
        else g.float().numpy() for g in grads]


NAMES = ('out', 'd_x', 'd_offsets', 'd_weight', 'd_mask')


@pytest.mark.parametrize('dtype,tol', [('float32', 1e-5), ('bfloat16', 2e-2)])
@pytest.mark.parametrize('with_mask', [False, True])
@pytest.mark.parametrize('geometry', [dict(), dict(stride=2),
                                      dict(dilation=2),
                                      dict(padding=0)])
def test_deform_conv_and_its_gradients_match_jax(dtype, tol, with_mask,
                                                  geometry):
    inp = _inputs(3, **geometry)
    ref = _jax(inp, getattr(jnp, dtype), with_mask, **geometry)
    got = _port(inp, getattr(torch, dtype), with_mask, **geometry)
    for name, g, r in zip(NAMES, got, ref):
        if name == 'd_mask' and not with_mask:
            continue
        assert g.shape == r.shape, name
        scale = max(float(np.abs(r).max()), 1e-6)
        err = float(np.abs(g - r).max())
        assert err <= tol * scale, f'{name}: {err:.3e} > {tol} x {scale:.3e}'


def test_single_image_form_matches_jax():
    inp = _inputs(4)
    ref = jdc.deform_conv2d(jnp.asarray(inp['x'][0], jnp.float32),
                            jnp.asarray(inp['offsets'][0], jnp.float32),
                            jnp.asarray(inp['weight'], jnp.float32),
                            bias=jnp.asarray([0.5, -1.0, 0.0, 2.0]),
                            mask=jnp.asarray(inp['mask'][0], jnp.float32))
    got = tdc.deform_conv2d(torch.tensor(inp['x'][0], dtype=torch.float32),
                            torch.tensor(inp['offsets'][0],
                                         dtype=torch.float32),
                            torch.tensor(inp['weight'], dtype=torch.float32),
                            bias=torch.tensor([0.5, -1.0, 0.0, 2.0]),
                            mask=torch.tensor(inp['mask'][0],
                                              dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5 * float(np.abs(ref).max()))


@pytest.mark.parametrize('geometry', [dict(), dict(stride=2),
                                      dict(dilation=2)])
def test_zero_offsets_give_the_plain_conv(geometry):
    inp = _inputs(5, **geometry)
    x = torch.tensor(inp['x'], dtype=torch.float32)
    w = torch.tensor(inp['weight'], dtype=torch.float32)
    off = torch.zeros(inp['offsets'].shape)
    got = tdc.batched_deform_conv2d(x, off, w, **geometry)
    d = geometry.get('dilation', 1)
    ref = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                   stride=geometry.get('stride', 1), padding=d,
                   dilation=d).permute(0, 2, 3, 1)
    assert got.shape == ref.shape
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=1e-5 * float(ref.abs().max()))


def test_bad_shapes_raise():
    x = torch.zeros(1, 5, 5, 3)
    with pytest.raises(ValueError, match='in_channels'):
        tdc.batched_deform_conv2d(x, torch.zeros(1, 5, 5, 18),
                                  torch.zeros(3, 3, 4, 2))
    with pytest.raises(ValueError, match='offsets'):
        tdc.batched_deform_conv2d(x, torch.zeros(1, 5, 5, 9),
                                  torch.zeros(3, 3, 3, 2))
