"""The one-stage core's configs, builder, converter and init:

- the R50 configs of RetinaNet (focal, fp16, GHM), FCOS (plain, the
  center-sampling GIoU row and its DCN head), ATSS, GFL and PAA build at
  full width in the port with the JAX package's parameter tree, every leaf
  converted (the per-level scales and the DCN kernels included);
- the flat config fields (dicts merged over the NamedTuple defaults)
  reach the port's modules as the JAX builder reads them, `--cfg-options`
  included; the ResNeXt (x101) and trunk-DCN (r101 dconv) configs, a
  NAS-FPN head and a neck other than the FPN raise with their reason;
- seeded random weights give the heads mmdet's std 0.01 (or the lecun
  scale), the classifiers' bias −4.595, the scales 1, the DCN kernels the
  `he_normal` scale and their offset convs zero;
- the one-stage core and the proposal family train on several ranks (they
  are not among the one-device detectors).
"""

import importlib
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .torch_port_utils import JAX_PKG, PORT_PKG

ROOT = pathlib.Path(__file__).resolve().parent.parent
CENTER = ('configs/fcos/fcos_center-normbbox-centeronreg-giou_r50_caffe_'
          'fpn_gn-head_1x.py')
CONFIGS = {
    'RetinaNet': 'configs/retinanet/retinanet_r50_fpn_1x.py',
    'RetinaNet/fp16': 'configs/retinanet/retinanet_r50_fpn_fp16_1x.py',
    'RetinaNet/ghm': 'configs/ghm/retinanet_ghm_r50_fpn_1x.py',
    'FCOS': 'configs/fcos/fcos_r50_fpn_1x.py',
    'FCOS/center': CENTER,
    'FCOS/dcn': CENTER.replace('_1x.py', '_dcn_1x.py'),
    'ATSS': 'configs/atss/atss_r50_fpn_1x.py',
    'GFL': 'configs/gfl/gfl_r50_fpn_1x.py',
    'PAA': 'configs/paa/paa_r50_fpn_1x.py'}

jbuilder = importlib.import_module(f'{JAX_PKG}.models.builder')
jconfig = importlib.import_module(f'{JAX_PKG}.utils.config')
tbuilder = importlib.import_module(f'{PORT_PKG}.models.builder')
tconfig = importlib.import_module(f'{PORT_PKG}.utils.config')
ttrain = importlib.import_module(f'{PORT_PKG}.apis.train')
tinference = importlib.import_module(f'{PORT_PKG}.apis.inference')
ttools_train = importlib.import_module(f'{PORT_PKG}.tools.train')
tretina = importlib.import_module(f'{PORT_PKG}.models.detectors.retinanet')
convert = importlib.import_module(f'{PORT_PKG}.utils.convert')


def _cfgs(path, options=None):
    j, t = (mod.Config.fromfile(str(ROOT / path))
            for mod in (jconfig, tconfig))
    for c in (j, t):
        c.merge_from_dict(options or {})
    return j, t


def _zero_tree(model):
    k0 = jax.random.PRNGKey(0)
    dummy = dict(image=jnp.zeros((1, 64, 64, 3)),
                 img_shape=jnp.full((1, 2), 64, jnp.int32))
    shapes = jax.eval_shape(lambda: model.init(
        {'params': k0, 'sampler': k0, 'dropout': k0}, dummy, train=False))
    return jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), shapes)


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_full_width_configs_build_with_the_jax_parameter_tree(name):
    jcfg, tcfg = _cfgs(CONFIGS[name])
    jmodel = jbuilder.build_detector(jcfg.model)
    model = tbuilder.build_detector(tcfg.model, device='meta')
    assert type(model).__name__ == type(jmodel).__name__
    assert model.num_classes == jmodel.num_classes == 80
    state, unmapped = convert.from_jax_variables(_zero_tree(jmodel), model)
    assert unmapped == []
    assert set(state) == set(model.state_dict())
    scales = [k for k in state if '.scale_' in k]
    assert len(scales) == (0 if name.startswith('RetinaNet') else 5)
    dcn = [k for k in state if '_dcn.' in k]
    assert dcn == (['bbox_head.cls_conv3_dcn.weight',
                    'bbox_head.reg_conv3_dcn.weight']
                   if name == 'FCOS/dcn' else [])


# flat fields a config may set (dicts merge over the NamedTuple defaults)
FIELDS = {
    'RetinaNet': {'model.anchor_cfg': dict(octave_base_scale=2),
                  'model.train_cfg': dict(pos_iou_thr=0.6, loss_cls='ghm'),
                  'model.test_cfg': dict(nms_pre=500, score_thr=0.1)},
    'FCOS/center': {'model.center_sample_radius': 2.0,
                    'model.strides': [8, 16, 32, 64, 128]},
    'ATSS': {'model.topk': 7},
    'GFL': {'model.anchor_scale': 3, 'model.reg_max': 12},
    'PAA': {'model.topk_per_level': 5}}


@pytest.mark.parametrize('name', sorted(FIELDS))
def test_flat_config_fields_are_read_as_jax_reads_them(name):
    options = dict({'model.backbone_depth': 18}, **FIELDS[name])
    jcfg, tcfg = _cfgs(CONFIGS[name], options)
    jmodel = jbuilder.build_detector(jcfg.model)
    tmodel = tbuilder.build_detector(tcfg.model, device='meta')
    for key in FIELDS[name]:
        field = key.split('.', 1)[1]
        got, ref = getattr(tmodel, field), getattr(jmodel, field)
        if hasattr(got, '_fields'):
            assert got._asdict() == {f: getattr(ref, f) for f in got._fields}
        else:
            assert got == (tuple(ref) if isinstance(got, tuple) else ref)
    if name == 'FCOS/center':
        assert tmodel.center_sampling and jmodel.center_sampling
        assert tmodel.test_cfg.nms_iou_threshold == 0.6


@pytest.mark.parametrize('option,field,value', [
    ('model.anchor_cfg.octave_base_scale=2', 'anchor_cfg', 2),
    ('model.anchor_scale=3', 'anchor_scale', 3)])
def test_cfg_options_reach_the_detector(option, field, value):
    """The synth rows' anchor fits, given on the command line."""
    model_type = 'RetinaNet' if field == 'anchor_cfg' else 'GFL'
    cfg = ttools_train.load_config(ttools_train.parse_args(
        ['configs/da/synth_zoo_smoke.py', '--cfg-options',
         f'model.type={model_type}', option]))
    model = tbuilder.build_detector(cfg.model, device='meta')
    got = getattr(model, field)
    if field == 'anchor_cfg':
        assert got.octave_base_scale == value and got.scales_per_octave == 3
        assert model.bbox_head.retina_cls.out_channels == 9 * 2
    else:
        assert got == value


@pytest.mark.parametrize('config', [
    'configs/retinanet/retinanet_x101_32x4d_fpn_1x.py',
    'configs/fcos/fcos_x101_64x4d_fpn_gn-head_mstrain_640-800_2x.py',
    'configs/gfl/gfl_x101_32x4d_fpn_mstrain_2x.py',
    'configs/gfl/gfl_r101_fpn_dconv_c3-c5_mstrain_2x.py'])
def test_resnext_and_trunk_dcn_configs_raise_with_their_reason(config):
    cfg = tconfig.Config.fromfile(str(ROOT / config))
    with pytest.raises(NotImplementedError, match='only SwinTransformer'):
        tbuilder.build_detector(cfg.model, device='meta')


@pytest.mark.parametrize('options,match', [
    ({'model.sep_bn_head': True}, 'NAS-FPN'),
    ({'model.neck_type': 'PAFPN'}, "'PAFPN'")])
def test_unported_retinanet_parts_raise(options, match):
    _, tcfg = _cfgs(CONFIGS['RetinaNet'], options)
    with pytest.raises(NotImplementedError, match=match):
        tbuilder.build_detector(tcfg.model, device='meta')


@pytest.mark.parametrize('heads', ['mmdet', 'lecun'])
@pytest.mark.parametrize('name', ['RetinaNet', 'FCOS/dcn', 'GFL'])
def test_random_init_gives_the_heads_their_scales(name, heads):
    _, tcfg = _cfgs(CONFIGS[name], {'model.backbone_depth': 18,
                                    'random_init.heads': heads})
    model = tinference.init_detector(tcfg, device='cpu', seed=3).model
    head = model.bbox_head
    assert torch.all(head.cls_output().bias == tretina.CLS_BIAS)
    for lvl in range(head.num_levels):
        assert float(getattr(head, f"scale_{lvl}").detach()) == 1.0
    dcn = head.dcn_layers()
    assert len(dcn) == (2 if name == 'FCOS/dcn' else 0)
    offsets = {id(o) for _, o in dcn}
    for layer, offset in dcn:
        assert not offset.weight.any() and not offset.bias.any()
        std = math.sqrt(2.0 / layer.weight[0].numel())
        assert abs(float(layer.weight.detach().std()) / std - 1) < 0.05
    convs = [m for m in head.modules() if isinstance(m, torch.nn.Conv2d)
             and id(m) not in offsets]
    assert len(convs) >= 9
    for conv in convs:
        want = 0.01 if heads == 'mmdet' else conv.weight[0].numel() ** -0.5
        assert abs(float(conv.weight.detach().std()) / want - 1) < 0.15


@pytest.mark.parametrize('model_type', [
    'RetinaNet', 'FCOS', 'ATSS', 'GFL', 'PAA', 'RPN', 'GARPN', 'GARetinaNet',
    'GAFasterRCNN', 'CascadeRPN', 'CRPNFasterRCNN'])
def test_one_stage_core_and_proposal_family_train_on_several_ranks(
        model_type):
    """Their losses take the global batch's normalizers
    (`test_torch_parallel_loop.py`), so no multi-rank entry point refuses
    them, where it refuses the one-device families."""
    cfg = tconfig.Config.fromfile(str(ROOT / CONFIGS['RetinaNet']))
    cfg.merge_from_dict({'model.type': model_type})
    ttrain._refuse_unported(cfg, 'jax', n_devices=2)
    cfg.merge_from_dict({'model.type': 'CascadeRCNN'})
    with pytest.raises(NotImplementedError, match='several ranks'):
        ttrain._refuse_unported(cfg, 'jax', n_devices=2)
