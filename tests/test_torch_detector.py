"""The whole slice: the port's `DAFasterRCNN.predict` and
`inference_detector` vs the JAX package's on the tiny-fixture config
(R18 trunk, 64x96 canvas), weights carried across by `from_jax_variables`.

Tolerances: dets within 1e-3 (trunk and heads differ by ~1e-5 of scale from
summation order); labels and valid identical. The seeds are ones whose
ranked scores are not tied, so those small differences cannot reorder the
selections.
"""

import importlib
import pathlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from .torch_port_utils import JAX_PKG, PORT_PKG, fill_variables

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = str(ROOT / 'configs/da/faster_rcnn_r18_tiny_fixture.py')
DA_HEADS = ('params/backbone/pixel_s', 'params/backbone/global_s',
            'batch_stats/backbone/pixel_s', 'batch_stats/backbone/global_s',
            'params/local_da_fore/', 'params/local_da_back/',
            'batch_stats/local_da_fore/', 'batch_stats/local_da_back/')

jbuilder = importlib.import_module(f'{JAX_PKG}.models.builder')
jconfig = importlib.import_module(f'{JAX_PKG}.utils.config')
jinference = importlib.import_module(f'{JAX_PKG}.apis.inference')
tapis = importlib.import_module(f'{PORT_PKG}.apis.inference')
convert = importlib.import_module(f'{PORT_PKG}.utils.convert')


def _leaf_paths(tree, prefix=''):
    if hasattr(tree, 'items'):
        for k, v in tree.items():
            yield from _leaf_paths(v, f'{prefix}{k}/')
    else:
        yield prefix[:-1]


def _tiny(det_type):
    """JAX tiny-fixture detector of `det_type` with random numpy weights
    (all leaves, DA heads included), and the port's counterpart loaded from
    them."""
    cfg = jconfig.Config.fromfile(TINY)
    cfg.model['type'] = det_type
    model = jbuilder.build_detector(cfg.model)
    b, (h, w) = 2, cfg.canvas
    dummy = dict(image=jnp.zeros((b, h, w, 3)),
                 img_shape=jnp.full((b, 2), h, jnp.int32),
                 gt_bboxes=jnp.zeros((b, 4, 4)),
                 gt_labels=jnp.zeros((b, 4), jnp.int32),
                 gt_valid=jnp.zeros((b, 4), bool),
                 domain=jnp.zeros((b,), jnp.int32))
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: model.init(
        {'params': k, 'sampler': k, 'dropout': k}, dummy, train=True))
    variables = fill_variables(shapes, np.random.RandomState(11))
    bundle = tapis.init_detector(cfg, variables=variables, device='cpu')
    return model, variables, bundle


@pytest.fixture(scope='module')
def tiny():
    return _tiny('DAFasterRCNN')


def test_converter_leaves_exactly_the_da_heads(tiny):
    """Every leaf maps now, the DA heads' params and batch_stats too: the
    set of leaves left over is empty."""
    _, variables, bundle = tiny
    state, unmapped = convert.from_jax_variables(variables, bundle.model)
    heads = {p for p in _leaf_paths(variables) if p.startswith(DA_HEADS)}
    assert heads
    assert unmapped == []
    assert set(state) == set(bundle.model.state_dict())
    assert {p.split('/', 1)[1].replace('/', '.').rsplit('.', 1)[0]
            for p in heads} <= {k.rsplit('.', 1)[0] for k in state}


@pytest.mark.parametrize('det_type', ['DAFasterRCNN', 'FasterRCNN'])
def test_predict_matches(tiny, det_type):
    model, variables, bundle = tiny if det_type == 'DAFasterRCNN' \
        else _tiny(det_type)
    rs = np.random.RandomState(3)
    image = rs.standard_normal((2, 64, 96, 3)).astype(np.float32)
    img_shape = np.array([[64, 96], [56, 80]], np.int32)
    ref = jax.jit(lambda v, bt: model.apply(v, bt, train=False))(
        variables, dict(image=jnp.asarray(image),
                        img_shape=jnp.asarray(img_shape)))
    got = bundle.model.predict(dict(image=torch.from_numpy(image),
                                    img_shape=torch.from_numpy(img_shape)))
    valid = np.asarray(ref['valid'])
    assert valid.sum() >= 10
    np.testing.assert_array_equal(got['valid'].numpy(), valid)
    np.testing.assert_array_equal(got['labels'].numpy(),
                                  np.asarray(ref['labels']))
    np.testing.assert_allclose(got['dets'].numpy(), np.asarray(ref['dets']),
                               atol=1e-3)


def test_inference_detector_matches_on_fixture_images(tiny):
    model, variables, tb = tiny
    paths = sorted((ROOT / 'tests/data/voc_source/JPEGImages').glob('*.jpg'))
    imgs = [np.asarray(Image.open(p).convert('RGB')) for p in paths]
    # the JAX bundle as its init_detector would make it for these weights;
    # its apply runs under jit (same outputs, one compile)
    img_scale = (96, 64)
    jb = jinference.DetectorBundle(
        SimpleNamespace(num_classes=model.num_classes,
                        apply=jax.jit(model.apply,
                                      static_argnames=('train',))),
        variables, tb.cfg, ('car', 'person'),
        jinference._default_canvas(img_scale), img_scale)
    assert (tb.canvas, tb.img_scale, tb.classes) == \
        (jb.canvas, jb.img_scale, jb.classes)
    ref = jinference.inference_detector(jb, imgs)
    got = tapis.inference_detector(tb, imgs)
    assert len(got) == len(imgs)
    assert sum(len(d) for r in ref for d in r) > 0
    for r_img, g_img in zip(ref, got):
        assert len(g_img) == len(r_img) == 2
        for r, g in zip(r_img, g_img):
            assert g.shape == r.shape and g.dtype == np.float32
            np.testing.assert_allclose(g, r, atol=1e-3)
    # a path goes through the port's own loader to the same result
    single = tapis.inference_detector(tb, str(paths[0]))
    for g, s in zip(got[0], single):
        np.testing.assert_allclose(s, g, atol=1e-3)
