"""The RetinaNet-derived heads' configs, builder, converter and init:

- the R50 configs of FreeAnchor, FSAF, FoveaBox, SABL-RetinaNet, SABL
  Faster R-CNN (plain and cascade), PISA-RetinaNet, PISA Faster R-CNN and
  PISA Mask R-CNN build at full width in the port with the JAX package's
  parameter tree, every leaf converted (SABL's 1-D and transposed convs
  and the cascade's `sabl_head_<i>` included);
- the flat config fields (dicts merged over the NamedTuple defaults)
  reach the port's modules as the JAX builder reads them, and
  `model.cascade=True` reaches SABL Faster R-CNN from the command line;
  the ResNeXt (x101) configs and the PISA SSD types raise with their
  reasons;
- seeded random weights give the one-stage heads mmdet's std 0.01 (or
  the lecun scale) and the classifiers' bias −4.595, and SABL's box head
  mmdet's `SABLHead` scales (or the lecun scale, its transposed convs over
  flax's fan-in);
- all but the SABL cascade train on several ranks.
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
CONFIGS = {
    'FreeAnchor': 'configs/free_anchor/retinanet_free_anchor_r50_fpn_1x.py',
    'FSAF': 'configs/fsaf/fsaf_r50_fpn_1x.py',
    'FoveaBox': 'configs/foveabox/fovea_r50_fpn_4x4_1x.py',
    'SABLRetinaNet': 'configs/sabl/sabl_retinanet_r50_fpn_1x.py',
    'SABLFasterRCNN': 'configs/sabl/sabl_faster_rcnn_r50_fpn_1x.py',
    'SABLFasterRCNN/cascade': 'configs/sabl/sabl_cascade_rcnn_r50_fpn_1x.py',
    'PISARetinaNet': 'configs/pisa/pisa_retinanet_r50_fpn_1x.py',
    'PISAFasterRCNN': 'configs/pisa/pisa_faster_rcnn_r50_fpn_1x.py',
    'PISAMaskRCNN': 'configs/pisa/pisa_mask_rcnn_r50_fpn_1x.py'}

jbuilder = importlib.import_module(f'{JAX_PKG}.models.builder')
jconfig = importlib.import_module(f'{JAX_PKG}.utils.config')
tbuilder = importlib.import_module(f'{PORT_PKG}.models.builder')
tconfig = importlib.import_module(f'{PORT_PKG}.utils.config')
ttrain = importlib.import_module(f'{PORT_PKG}.apis.train')
tinference = importlib.import_module(f'{PORT_PKG}.apis.inference')
ttools_train = importlib.import_module(f'{PORT_PKG}.tools.train')
tretina = importlib.import_module(f'{PORT_PKG}.models.detectors.retinanet')
tsabl = importlib.import_module(f'{PORT_PKG}.models.detectors.sabl_retina')
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
    heads = sorted({k.split('.')[0] for k in state
                    if k.startswith('sabl_head_')})
    assert heads == {'SABLFasterRCNN': ['sabl_head_0'],
                     'SABLFasterRCNN/cascade': ['sabl_head_0',
                                                'sabl_head_1']}.get(name, [])
    if heads:
        assert state['sabl_head_0.up_x.weight'].shape == (256, 256, 2)
        assert state['sabl_head_0.reg_post_y.weight'].shape == (256, 256, 3)


# flat fields a config may set (dicts merge over the NamedTuple defaults)
FIELDS = {
    'FreeAnchor': {'model.pre_anchor_topk': 30, 'model.bbox_thr': 0.5,
                   'model.test_cfg': dict(nms_pre=500, score_thr=0.1)},
    'FSAF': {'model.pos_scale': 0.3, 'model.normalize_factor': 2.0},
    'FoveaBox': {'model.sigma': 0.5, 'model.strides': [8, 16, 32, 64, 128]},
    'SABLRetinaNet': {'model.scale_factor': 2.0},
    'SABLFasterRCNN': {'model.scale_factor': 1.5, 'model.cascade': True},
    'PISARetinaNet': {'model.train_cfg': dict(pos_iou_thr=0.6),
                      'model.anchor_cfg': dict(octave_base_scale=2)},
    'PISAFasterRCNN': {'model.roi_train_cfg': dict(num_samples=64),
                       'model.rpn_proposal_cfg': dict(max_per_img=500)}}


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


def test_cascade_reaches_sabl_faster_rcnn_from_the_command_line():
    cfg = ttools_train.load_config(ttools_train.parse_args(
        ['configs/da/synth_sabl_smoke.py', '--cfg-options',
         'model.cascade=True']))
    model = tbuilder.build_detector(cfg.model, device='meta')
    assert model.cascade and [type(h).__name__ for h in model.bbox_heads] \
        == ['SABLBBoxHead'] * 2
    assert [model.stage_cfg(i).pos_iou_thr for i in range(2)] == [0.5, 0.6]
    assert not model.stage_cfg(1).match_low_quality


@pytest.mark.parametrize('config', [
    'configs/free_anchor/retinanet_free_anchor_x101_32x4d_fpn_1x.py',
    'configs/fsaf/fsaf_x101_64x4d_fpn_1x.py',
    'configs/pisa/pisa_retinanet_x101_32x4d_fpn_1x.py',
    'configs/pisa/pisa_faster_rcnn_x101_32x4d_fpn_1x.py'])
def test_resnext_configs_raise_with_their_reason(config):
    cfg = tconfig.Config.fromfile(str(ROOT / config))
    with pytest.raises(NotImplementedError, match='only SwinTransformer'):
        tbuilder.build_detector(cfg.model, device='meta')


@pytest.mark.parametrize('config', ['configs/pisa/pisa_ssd300_coco.py',
                                    'configs/pisa/pisa_ssdlite_coco.py'])
def test_pisa_ssd_types_wait_for_ssd(config):
    cfg = tconfig.Config.fromfile(str(ROOT / config))
    with pytest.raises(NotImplementedError,
                       match=r'not ported \(ssd, ROADMAP.md Queue 1 item 4'):
        tbuilder.build_detector(cfg.model, device='meta')


@pytest.mark.parametrize('heads', ['mmdet', 'lecun'])
@pytest.mark.parametrize('name', ['FSAF', 'FoveaBox', 'SABLRetinaNet',
                                  'FreeAnchor'])
def test_random_init_gives_the_dense_heads_their_scales(name, heads):
    _, tcfg = _cfgs(CONFIGS[name], {'model.backbone_depth': 18,
                                    'random_init.heads': heads})
    head = tinference.init_detector(tcfg, device='cpu', seed=3).model \
        .bbox_head
    assert isinstance(head, tretina.TowerHead)
    assert torch.all(head.cls_output().bias == tretina.CLS_BIAS)
    convs = [m for m in head.modules() if isinstance(m, torch.nn.Conv2d)]
    assert len(convs) >= 9
    for conv in convs:
        want = 0.01 if heads == 'mmdet' else conv.weight[0].numel() ** -0.5
        assert abs(float(conv.weight.detach().std()) / want - 1) < 0.15


@pytest.mark.parametrize('heads', ['mmdet', 'lecun'])
def test_random_init_gives_the_sabl_box_head_its_scales(heads):
    _, tcfg = _cfgs(CONFIGS['SABLFasterRCNN'], {'model.backbone_depth': 18,
                                                'random_init.heads': heads})
    head = tinference.init_detector(tcfg, device='cpu', seed=3).model \
        .sabl_head_0
    cls, bucket_cls, bucket_off = head.predictors()
    for layer, std in [(cls, 0.01)] + [(f, 0.01) for f in bucket_cls] + \
            [(f, 0.001) for f in bucket_off]:
        want = std if heads == 'mmdet' else layer.weight[0].numel() ** -0.5
        assert abs(float(layer.weight.detach().std()) / want - 1) < 0.15
    for layer in (head.up_x, head.reg_post_x, head.cls_fc1, head.reg_pre0):
        w = layer.weight.detach()
        fan_in = w.shape[0] * w.shape[2] if layer is head.up_x \
            else w[0].numel()
        assert abs(float(w.std()) * math.sqrt(fan_in) - 1) < 0.05
        assert not layer.bias.any()


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_several_ranks_take_all_but_the_sabl_cascade(name):
    """Their losses take the global batch's normalizers
    (`test_torch_parallel_loop.py`); the SABL cascade has the cascade
    family's one-device step."""
    cfg = tconfig.Config.fromfile(str(ROOT / CONFIGS[name]))
    if name.endswith('cascade'):
        with pytest.raises(NotImplementedError, match='several ranks'):
            ttrain._refuse_unported(cfg, 'jax', n_devices=2)
    else:
        ttrain._refuse_unported(cfg, 'jax', n_devices=2)
