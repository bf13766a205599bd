"""The proposal-network family's configs, builder, converter and init:

- the eight R50 configs (RPN FPN and C4, Fast R-CNN, GA-RPN, GA-RetinaNet,
  GA-Faster R-CNN, Cascade RPN, CRPN-Faster R-CNN) build at full width in
  the port with the JAX package's parameter tree, every leaf converted
  (the adaptive convs' raw HWIO kernels included);
- the flat config fields reach the port's modules as the JAX builder reads
  them; the ResNeXt (x101) configs and a BFP neck raise with their reason;
- at `dtype=bfloat16` the adaptive kernels are bf16 parameters, as the JAX
  package makes them, while every conv keeps f32 ones; they convert
  exactly, train and stay bf16;
- the Fast R-CNN configs fail their first step in both packages, because
  `PackDetInputs` does not carry `LoadProposals`' output (found in the
  reference);
- seeded random weights give the adaptive layers the JAX package's init.
"""

import importlib
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .test_torch_cascade import _t
from .test_torch_rpn_detectors import CONFIGS, TINY, fixed_proposals
from .test_torch_train import _demo_batch
from .torch_port_utils import JAX_PKG, PORT_PKG, fill_variables

ROOT = pathlib.Path(__file__).resolve().parent.parent

jbuilder = importlib.import_module(f'{JAX_PKG}.models.builder')
jconfig = importlib.import_module(f'{JAX_PKG}.utils.config')
jtf = importlib.import_module(f'{JAX_PKG}.data.pipelines.transforms')
tbuilder = importlib.import_module(f'{PORT_PKG}.models.builder')
tconfig = importlib.import_module(f'{PORT_PKG}.utils.config')
ttf = importlib.import_module(f'{PORT_PKG}.data.pipelines.transforms')
ttrain = importlib.import_module(f'{PORT_PKG}.apis.train')
tinference = importlib.import_module(f'{PORT_PKG}.apis.inference')
trpn = importlib.import_module(f'{PORT_PKG}.models.detectors.rpn_detectors')
convert = importlib.import_module(f'{PORT_PKG}.utils.convert')


def _cfgs(name, options=None):
    path = str(ROOT / CONFIGS[name])
    j, t = jconfig.Config.fromfile(path), tconfig.Config.fromfile(path)
    for c in (j, t):
        c.merge_from_dict(options or {})
    return j, t


def _jax_shapes(model, proposals=False):
    k0 = jax.random.PRNGKey(0)
    dummy = dict(image=jnp.zeros((1, 64, 64, 3)),
                 img_shape=jnp.full((1, 2), 64, jnp.int32))
    if proposals:
        dummy.update(proposals=jnp.zeros((1, 8, 4)),
                     proposals_valid=jnp.ones((1, 8), bool))
    return jax.eval_shape(lambda: model.init(
        {'params': k0, 'sampler': k0, 'dropout': k0}, dummy, train=False))


def _zeros(shapes):
    return jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), shapes)


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_full_width_configs_build_with_the_jax_parameter_tree(name):
    jcfg, tcfg = _cfgs(name)
    model = tbuilder.build_detector(tcfg.model, device='meta')
    jmodel = jbuilder.build_detector(jcfg.model)
    assert model.num_classes == jmodel.num_classes
    shapes = _jax_shapes(jmodel, proposals=name == 'FastRCNN')
    state, unmapped = convert.from_jax_variables(_zeros(shapes), model)
    assert unmapped == []
    assert set(state) == set(model.state_dict())


# flat-config fields and the module attributes they land on
FIELDS = {
    'RPN': {'model.rpn_strides': [4, 8, 16, 32, 64],
            'model.test_cfg': dict(nms_pre=777, nms_iou_threshold=0.6)},
    'RPN/c4': {'model.rpn_train_cfg': dict(num_samples=128)},
    'FastRCNN': {'model.roi_train_cfg': dict(num_samples=64),
                 'model.roi_test_cfg': dict(score_thr=0.2)},
    'GARPN': {'model.loc_filter_thr': 0.05, 'model.center_ratio': 0.3,
              'model.octave_base': 4.0},
    'GARetinaNet': {'model.strides': [4, 8, 16, 32, 64],
                    'model.test_cfg': dict(score_thr=0.1)},
    'GAFasterRCNN': {'model.rpn_proposal_cfg': dict(max_per_img=99),
                     'model.loc_filter_thr': 0.02},
    'CascadeRPN': {'model.anchor_scale': 6.0},
    'CRPNFasterRCNN': {'model.rpn_weight': 0.5,
                       'model.test_cfg': dict(nms_pre=1000)}}


@pytest.mark.parametrize('name', sorted(FIELDS))
def test_flat_config_fields_are_read_as_jax_reads_them(name):
    jcfg, tcfg = _cfgs(name, dict(TINY, **FIELDS[name]))
    jmodel = jbuilder.build_detector(jcfg.model)
    tmodel = tbuilder.build_detector(tcfg.model, device='meta')
    for key in FIELDS[name]:
        field = key.split('.', 1)[1]
        got, ref = getattr(tmodel, field), getattr(jmodel, field)
        if hasattr(got, '_fields'):     # the port's fields of the config
            assert all(getattr(ref, f) == v
                       for f, v in got._asdict().items()), field
        elif isinstance(got, tuple):
            assert got == tuple(ref), field
        else:
            assert got == ref, field
    if name == 'RPN/c4':
        assert tmodel.c4 and jmodel.c4
    if name == 'GARetinaNet':
        # strides from 4 move the neck to P2 and drop the extra convs
        assert tmodel.neck.start_level == 0
        assert not tmodel.neck.add_extra_convs
        assert tmodel.ga_head.stacked_convs == 4


@pytest.mark.parametrize('config', [
    'configs/rpn/rpn_x101_32x4d_fpn_1x.py',
    'configs/guided_anchoring/ga_rpn_x101_32x4d_fpn_1x.py',
    'configs/guided_anchoring/ga_retinanet_x101_64x4d_fpn_1x.py',
    'configs/guided_anchoring/ga_faster_x101_32x4d_fpn_1x.py'])
def test_resnext_configs_raise_with_their_reason(config):
    cfg = tconfig.Config.fromfile(str(ROOT / config))
    with pytest.raises(NotImplementedError, match='ResNeXt'):
        tbuilder.build_detector(cfg.model, device='meta')


def test_fast_rcnn_with_a_bfp_neck_raises():
    _, tcfg = _cfgs('FastRCNN', {'model.neck_type': 'BFP'})
    with pytest.raises(NotImplementedError, match="'BFP'"):
        tbuilder.build_detector(tcfg.model, device='meta')


@pytest.mark.parametrize('name,keys', [
    ('GARPN', ('ga_head.adapt_conv_w',)),
    ('CRPNFasterRCNN', ('s2_adapt_w',))])
def test_bf16_adaptive_kernels_are_bf16_parameters_as_in_jax(name, keys):
    """The JAX package makes the adaptive convs' kernels with `self.param(
    ..., self.dtype)`: bf16 parameters in a bf16 detector, where every
    `nn.Conv` keeps f32 ones. The port copies this: the tree converts
    exactly, and a bf16 train step keeps those kernels (and their
    momentum) bf16 and moves them."""
    jcfg, tcfg = _cfgs(name, dict(TINY, **{'model.dtype': 'bfloat16'}))
    shapes = _jax_shapes(jbuilder.build_detector(jcfg.model))
    flat = {'/'.join(str(getattr(k, 'key', k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                shapes['params'])[0]}
    raw = {p: v for p, v in flat.items()
           if p.endswith(('adapt_conv_w', 's2_adapt_w'))}
    assert raw and all(v.dtype == jnp.bfloat16 for v in raw.values())
    assert all(v.dtype == jnp.float32 for p, v in flat.items()
               if p.endswith('kernel'))

    variables = jax.tree_util.tree_map(
        lambda v, s: np.asarray(v, s.dtype),
        fill_variables(shapes, np.random.RandomState(0)), shapes)
    trainer = ttrain.init_trainer(tcfg, variables=variables, device='cpu',
                                  steps_per_epoch=1)
    params = dict(trainer.model.named_parameters())
    for key in keys:
        assert params[key].dtype == torch.bfloat16
        jleaf = raw[key.replace('.', '/')]
        np.testing.assert_array_equal(
            params[key].detach().float().numpy(),
            np.asarray(_leaf(variables['params'], key), np.float32))
        assert jleaf.shape == tuple(params[key].shape)
    assert all(p.dtype == torch.float32 for n, p in params.items()
               if n not in keys)

    batch = {k: _t(v) for k, v in _demo_batch().items()}
    before = {k: params[k].detach().clone() for k in keys}
    state, metrics = trainer.step(trainer.state, batch,
                                  torch.Generator().manual_seed(0))
    assert all(torch.isfinite(v) for v in metrics.values())
    for key in keys:
        assert state.params[key].dtype == torch.bfloat16
        assert state.opt_state.momentum[key].dtype == torch.bfloat16
        assert not torch.equal(state.params[key], before[key])


def _leaf(tree, dotted):
    for part in dotted.split('.'):
        tree = tree[part]
    return tree


def test_fast_rcnn_config_fails_its_first_step_without_proposals():
    """`LoadProposals` fills `proposals`, but the configs' `PackDetInputs`
    does not carry them in either package: the JAX Fast R-CNN loss raises
    a KeyError on the first step (traced with `jax.eval_shape`, nothing
    compiled), and the port's step raises one that says so, before any
    forward pass."""
    results = dict(img=np.zeros((32, 48, 3), np.float32), img_shape=(32, 48),
                   ori_shape=(32, 48), gt_bboxes=np.zeros((0, 4), np.float32),
                   gt_labels=np.zeros((0,), np.int64),
                   proposals=np.ones((5, 4), np.float32))
    jpacked = jtf.PackDetInputs(max_gt=3)(jtf.LoadProposals(8)(
        dict(results)))
    tpacked = ttf.PackDetInputs(max_gt=3)(ttf.LoadProposals(8)(dict(
        results, img=torch.zeros((32, 48, 3)))))
    assert 'proposals' not in jpacked and 'proposals' not in tpacked

    jcfg, tcfg = _cfgs('FastRCNN', TINY)
    model = jbuilder.build_detector(jcfg.model)
    batch = {k: v[:1] for k, v in _demo_batch().items()}
    variables = _jax_shapes(model, proposals=True)
    k = jax.random.PRNGKey(0)

    def loss(v, b):
        return model.apply(v, b, train=True, rngs={'sampler': k,
                                                   'dropout': k})
    with pytest.raises(KeyError, match='proposals'):
        jax.eval_shape(loss, variables, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
    trainer = ttrain.init_trainer(tcfg, device='cpu', steps_per_epoch=1)
    with pytest.raises(KeyError, match='LoadProposals'):
        trainer.step(trainer.state, {k: _t(v) for k, v in batch.items()},
                     torch.Generator().manual_seed(0))
    # given proposals, the same step trains
    batch['proposals'], batch['proposals_valid'] = fixed_proposals(
        np.random.RandomState(0), 1, 16, 128, 192)
    _, metrics = trainer.step(trainer.state,
                              {k: _t(v) for k, v in batch.items()},
                              torch.Generator().manual_seed(0))
    assert all(torch.isfinite(v) for v in metrics.values())


@pytest.mark.parametrize('heads', ['mmdet', 'lecun'])
@pytest.mark.parametrize('name', ['GARetinaNet', 'CascadeRPN'])
def test_random_init_gives_the_adaptive_layers_the_jax_init(name, heads):
    """The adaptive convs' kernels at flax's `he_normal` scale (std
    sqrt(2 / fan_in)), the offset convs zero (so the first step's adaptive
    convs are plain convs), the GA location and class logits' bias −4.595
    (sigmoid 0.01); the prediction convs at mmdet's std 0.01 by default
    (at the lecun scale a full-width GA-RPN step at the COCO lr diverged)
    and at the lecun scale, as the JAX package draws them, with
    `random_init.heads=lecun`."""
    _, tcfg = _cfgs(name, dict(TINY, **{'random_init.heads': heads}))
    model = tinference.init_detector(tcfg, device='cpu', seed=3).model
    if name == 'GARetinaNet':
        head = model.ga_head
        adapt, offset = head.adapt_conv_w, head.conv_offset.weight
        for conv in (head.conv_loc, head.conv_cls):
            assert torch.all(conv.bias == trpn.LOC_BIAS)
        preds = (head.conv_loc, head.conv_shape, head.conv_cls,
                 head.conv_reg)
    else:
        adapt, offset = model.s2_adapt_w, model.s2_offset.weight
        preds = (model.s1_conv, model.s1_reg, model.s2_cls, model.s2_reg)
    assert not offset.any()
    std = math.sqrt(2.0 / (9 * adapt.shape[2]))
    assert abs(float(adapt.detach().std()) / std - 1) < 0.02
    assert abs(float(adapt.detach().mean())) < 0.02 * std
    for conv in preds:
        want = 0.01 if heads == 'mmdet' else conv.weight[0].numel() ** -0.5
        assert abs(float(conv.weight.detach().std()) / want - 1) < 0.15
