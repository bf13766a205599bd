"""Port's RPN head, proposal generation, Shared2FC head and RoI-head
inference vs the JAX package's, on the same numpy inputs and weights."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from .torch_port_utils import JAX_PKG, PORT_PKG, fill_variables

jrpn = importlib.import_module(f'{JAX_PKG}.models.dense_heads.rpn_head')
jbbox = importlib.import_module(f'{JAX_PKG}.models.roi_heads.bbox_head')
jroi = importlib.import_module(f'{JAX_PKG}.models.roi_heads.standard_roi_head')
jfrcnn = importlib.import_module(f'{JAX_PKG}.models.detectors.faster_rcnn')
trpn = importlib.import_module(f'{PORT_PKG}.models.dense_heads.rpn_head')
tbbox = importlib.import_module(f'{PORT_PKG}.models.roi_heads.bbox_head')
troi = importlib.import_module(f'{PORT_PKG}.models.roi_heads.standard_roi_head')
convert = importlib.import_module(f'{PORT_PKG}.utils.convert')


def _init(jmodel, tmodel, seed, *args):
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                *args))
    variables = fill_variables(shapes, np.random.RandomState(seed))
    assert convert.load_jax_variables(tmodel, variables) == []
    return variables


def test_rpn_head_forward():
    rs = np.random.RandomState(0)
    x = rs.standard_normal((2, 4, 6, 32)).astype(np.float32)
    jm = jrpn.RPNHead(feat_channels=64, num_anchors=6)
    tm = trpn.RPNHead(in_channels=32, feat_channels=64, num_anchors=6)
    variables = _init(jm, tm, 1, jnp.asarray(x))
    rc, rr = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        gc, gr = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(gc.numpy(), np.asarray(rc), atol=1e-5)
    np.testing.assert_allclose(gr.numpy(), np.asarray(rr), atol=1e-5)


def test_rpn_proposals_match():
    """Same logits into both: top-k, decode, clip (per-image shapes),
    min-size filter, NMS over two tiles, top-k."""
    rs = np.random.RandomState(2)
    h, w, a = 6, 9, 6
    anchors = jfrcnn.AnchorConfig(scales=(1, 2)).grid_anchors(h, w)
    cls = rs.standard_normal((2, h, w, a)).astype(np.float32)
    reg = (0.5 * rs.standard_normal((2, h, w, a * 4))).astype(np.float32)
    img_shape = np.array([[96, 144], [70, 100]], np.int32)
    cfgs = [(jrpn.ProposalConfig(nms_pre=200, max_per_img=80,
                                 nms_iou_threshold=0.6, min_bbox_size=2.0,
                                 nms_tile=128),
             trpn.ProposalConfig(200, 80, 0.6, 2.0, 128)),
            (jrpn.ProposalConfig(nms_pre=4096, max_per_img=1000),
             trpn.ProposalConfig(4096, 1000))]
    for jc, tc in cfgs:
        ref = jrpn.rpn_proposals(jnp.asarray(cls), jnp.asarray(reg),
                                 jnp.asarray(anchors), jnp.asarray(img_shape),
                                 jc)
        got = trpn.rpn_proposals(torch.from_numpy(cls), torch.from_numpy(reg),
                                 torch.from_numpy(anchors),
                                 torch.from_numpy(img_shape), tc)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                                   atol=1e-4)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                                   atol=1e-6)


def test_shared2fc_head_both_input_forms():
    rs = np.random.RandomState(3)
    feats = rs.standard_normal((2, 5, 7, 7, 16)).astype(np.float32)
    jm = jbbox.Shared2FCBBoxHead(num_classes=3)
    tm = tbbox.Shared2FCBBoxHead(num_classes=3, in_channels=16)
    variables = _init(jm, tm, 4, jnp.asarray(feats))
    ref = jm.apply(variables, jnp.asarray(feats))
    flat = torch.from_numpy(feats).transpose(2, 3).reshape(2, 5, -1)
    with torch.no_grad():
        for inp in (torch.from_numpy(feats), flat):
            for r, g in zip(ref, tm(inp)):
                np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                           atol=1e-4)


def test_roi_head_predict_matches():
    rs = np.random.RandomState(5)
    b, h, w, c, p, k = 2, 4, 6, 16, 40, 3
    feats = rs.standard_normal((b, h, w, c)).astype(np.float32)
    xy = rs.uniform(0, 80, (b, p, 2))
    wh = rs.uniform(4, 40, (b, p, 2))
    props = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    prop_valid = rs.rand(b, p) > 0.2
    props *= prop_valid[..., None]
    img_shape = np.array([[64, 96], [60, 80]], np.int32)
    jm = jbbox.Shared2FCBBoxHead(num_classes=k)
    tm = tbbox.Shared2FCBBoxHead(num_classes=k, in_channels=c)
    variables = _init(jm, tm, 6, jnp.zeros((b, p, 7 * 7 * c)))
    jcfg = jroi.RoITestConfig(max_per_img=20)
    ref = jroi.roi_head_predict(
        lambda f: jm.apply(variables, f), jnp.asarray(feats),
        jnp.asarray(props), jnp.asarray(prop_valid), jnp.asarray(img_shape),
        k, cfg=jcfg)
    with torch.no_grad():
        got = troi.roi_head_predict(
            tm, torch.from_numpy(feats), torch.from_numpy(props),
            torch.from_numpy(prop_valid), torch.from_numpy(img_shape), k,
            cfg=troi.RoITestConfig(max_per_img=20))
    assert np.asarray(ref['valid']).sum() > 10
    np.testing.assert_array_equal(got['valid'].numpy(),
                                  np.asarray(ref['valid']))
    np.testing.assert_array_equal(got['labels'].numpy(),
                                  np.asarray(ref['labels']))
    np.testing.assert_allclose(got['dets'].numpy(), np.asarray(ref['dets']),
                               atol=1e-3)
