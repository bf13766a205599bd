"""The port's bf16 FPN and Mask R-CNN paths against the JAX package at
`dtype=jnp.bfloat16` on the CPU: `predict` of the tiny FPN detector (the
Cityscapes FPN config with an R18 trunk, a 64-channel neck and 2 classes),
one train step of the tiny Mask R-CNN FPN through the `fp16` gate of
`configs/mask_rcnn/mask_rcnn_r50_fpn_fp16_1x.py`, and one train step of
the tiny Mask R-CNN C4.

The helpers and tolerances are those of `test_torch_bf16_train.py`: the
same weights and batch on both sides, the same proposals and sampler
priorities; losses within 2e-2 relative, the SGD update within 5e-2 of its
scale; detections with identical labels and validity, boxes within 2e-2 of
the canvas and scores within 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from .test_torch_bf16_train import (MASK_FP16, STEP, _fixed_proposals,
                                    _jax_model, _losses_held, _paired_step,
                                    _port_cfg, _update_held, tapis)
from .test_torch_fpn import FPN_CFG, TINY, regression_init
from .test_torch_mask import C4_CFG, C4_TINY
from .torch_port_utils import fill_variables

# 32 proposals, so the box head's 2 x 32 candidates stay under the 100
# detections kept: no cut at near-equal scores
FEW = dict(TINY, **{'model.rpn_test_cfg': dict(nms_pre=256,
                                               max_per_img=32)})
BF16_FPN = dict(FEW, **{
    'model.dtype': 'bfloat16',
    'data.test.pipeline': [dict(type='MultiScaleFlipAug',
                                img_scale=(160, 96))]})


def test_fpn_predict_bf16():
    """Trunk, neck, RPN and box head at bf16 over P2–P6, the four-level
    RoIAlign on bf16 maps, the f32 decode and NMS."""
    jmodel = _jax_model(FPN_CFG, FEW)
    rs = np.random.RandomState(3)
    image = rs.standard_normal((2, 96, 160, 3)).astype(np.float32)
    img_shape = np.array([[96, 160], [80, 128]], np.int32)
    batch = dict(image=image, img_shape=img_shape)
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {'params': k, 'sampler': k, 'dropout': k},
        {n: jnp.asarray(v) for n, v in batch.items()}, train=False))
    # a weight seed with no NMS decision at an IoU or score boundary (ten
    # of the first twelve are such seeds)
    rs = np.random.RandomState(1)
    variables = regression_init(fill_variables(shapes, rs), rs)
    # the classifier at a quarter of the lecun scale: scores spread over
    # (0, 1) rather than all within 1e-3 of 1, where bf16 logits tie
    cls = variables['params']['bbox_head']['fc_cls']
    cls['kernel'] = cls['kernel'] / 4
    bundle = tapis.init_detector(_port_cfg(FPN_CFG, BF16_FPN),
                                 variables=variables, device='cpu')
    model = bundle.model
    assert model.dtype == torch.bfloat16
    with _fixed_proposals(jmodel, model, batch, model.rpn_test_cfg):
        ref = jax.jit(lambda v, bt: jmodel.apply(v, bt, train=False))(
            variables, {n: jnp.asarray(v) for n, v in batch.items()})
        got = model.predict({n: torch.from_numpy(v)
                             for n, v in batch.items()})
    valid = np.asarray(ref['valid'])
    assert valid.sum() >= 20
    np.testing.assert_array_equal(got['valid'].numpy(), valid)
    for i in range(2):
        _same_detections(got['dets'][i].numpy(), got['labels'][i].numpy(),
                         np.asarray(ref['dets'][i]),
                         np.asarray(ref['labels'][i]), valid[i])


def _same_detections(dets, labels, want, want_labels, valid):
    """Each valid JAX detection has its own port detection of the same
    label, box within 2e-2 of the canvas and score within 2e-2. Matched as
    sets: scores from bf16 logits tie or sit an ulp apart, so the two sides
    may rank near-equal detections in another order."""
    free = list(np.flatnonzero(valid))
    for j in np.flatnonzero(valid):
        close = [k for k in free if labels[k] == want_labels[j]
                 and np.abs(dets[k, :4] - want[j, :4]).max() <= 2e-2 * 160
                 and abs(dets[k, 4] - want[j, 4]) <= 2e-2]
        assert close, (j, want[j], want_labels[j])
        free.remove(close[0])


def test_mask_fpn_step_through_the_fp16_gate():
    """The fp16 config with no `model.dtype` trains in bf16: the box and
    mask heads at bf16, the 14x14 mask features from bf16 maps, the mask
    targets and the losses in f32."""
    run = _paired_step(MASK_FP16, dict(TINY, **STEP), 5, port_overrides={},
                       mask=True, fpn=True, regression=True)
    model = run['trainer'].model
    assert model.dtype == torch.bfloat16
    assert model.mask_head.conv_logits.compute_dtype == torch.bfloat16
    _losses_held(run, {'loss_rpn_cls', 'loss_rpn_bbox', 'loss_cls',
                       'loss_bbox', 'loss_mask'})
    _update_held(run)


def test_c4_step_bf16():
    run = _paired_step(C4_CFG, dict(C4_TINY, **STEP), 3, mask=True,
                       regression=True)
    _losses_held(run, {'loss_rpn_cls', 'loss_rpn_bbox', 'loss_cls',
                       'loss_bbox', 'loss_mask'})
    _update_held(run)
