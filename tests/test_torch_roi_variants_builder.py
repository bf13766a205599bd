"""The builder and the converter on the eight configs of the RoI-head
variants' slice (`test_torch_roi_variants.CONFIGS`), the ResNeXt rows that
raise, Dynamic R-CNN's beta against the JAX expression, and the
multi-rank refusal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .test_torch_roi_variants import (CONFIGS, ROOT, convert, jbuilder,
                                      jconfig, tbuilder, tconfig, ttrain,
                                      tvariants)

# config → (port type, extractor, heads beside the trunk, neck and RPN)
ROUTES = {
    'DoubleHeadRCNN': ('DoubleHeadRCNN', 'single', {'bbox_head'}),
    'DynamicRCNN': ('DynamicRCNN', 'single', {'bbox_head'}),
    'GridRCNN': ('GridRCNN', 'single', {'bbox_head', 'grid_head'}),
    'MaskScoringRCNN': ('MaskScoringRCNN', 'single',
                        {'bbox_head', 'mask_head', 'mask_iou_head'}),
    'PointRend': ('PointRend', 'single',
                  {'bbox_head', 'mask_head', 'point_head'}),
    'FasterRCNNFPN/groie': ('FasterRCNNFPN', 'groie', {'bbox_head'}),
    'MaskRCNN/groie': ('MaskRCNN', 'groie', {'bbox_head', 'mask_head'}),
    'GridRCNN/groie': ('GridRCNN', 'groie', {'bbox_head', 'grid_head'})}


@pytest.mark.parametrize('name', sorted(ROUTES))
def test_builder_routes_the_config(name):
    """Each config of the slice builds its type at full width (R50, 80
    classes) with its extractor and heads, as the JAX builder does."""
    cfg = tconfig.Config.fromfile(str(ROOT / CONFIGS[name]))
    model = tbuilder.build_detector(cfg.model, device='meta')
    kind, extractor, heads = ROUTES[name]
    assert type(model).__name__ == kind
    assert model.roi_extractor_type == extractor
    assert model.num_classes == 80
    assert len(model.backbone.layer3) == 6                    # R50
    tops = {k.split('.')[0] for k in model.state_dict()}
    assert tops == {'backbone', 'neck', 'rpn_head'} | heads
    jcfg = jconfig.Config.fromfile(str(ROOT / CONFIGS[name]))
    jmodel = jbuilder.build_detector(jcfg.model)
    assert type(jmodel).__name__ == kind
    assert getattr(jmodel, 'roi_extractor_type') == extractor


@pytest.mark.parametrize('config', [
    'configs/grid_rcnn/grid_rcnn_x101_32x4d_fpn_gn-head_2x.py',
    'configs/grid_rcnn/grid_rcnn_x101_64x4d_fpn_gn-head_2x.py',
    'configs/ms_rcnn/ms_rcnn_x101_64x4d_fpn_1x.py'])
def test_builder_refuses_the_resnext_rows(config):
    """A trunk the port lacks raises with its reason (ResNeXt)."""
    cfg = tconfig.Config.fromfile(str(ROOT / config))
    with pytest.raises(NotImplementedError, match='ResNeXt'):
        tbuilder.build_detector(cfg.model, device='meta')


@pytest.mark.parametrize('name', ['DoubleHeadRCNN', 'GridRCNN',
                                  'MaskScoringRCNN', 'PointRend'])
def test_converter_maps_every_leaf_of_the_full_width_heads(name):
    """The full-width JAX tree of each type with a head of its own (the
    Double-Head, grid with its group norms, MaskIoU and point heads; their
    first FC rows in (y, x, C) order, the order the port feeds them) carries
    across with no unmapped leaf and covers every tensor of the port's
    model."""
    jcfg = jconfig.Config.fromfile(str(ROOT / CONFIGS[name]))
    model = jbuilder.build_detector(jcfg.model)
    dummy = dict(image=jnp.zeros((1, 64, 64, 3)),
                 img_shape=jnp.full((1, 2), 64, jnp.int32))
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: model.init(
        {'params': k, 'sampler': k, 'dropout': k}, dummy, train=False))
    tree = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), shapes)
    port = tbuilder.build_detector(
        tconfig.Config.fromfile(str(ROOT / CONFIGS[name])).model,
        device='meta')
    state, unmapped = convert.from_jax_variables(tree, port)
    assert unmapped == []
    assert set(state) == set(port.state_dict())


@pytest.mark.parametrize('case', ['ties', 'few_positives', 'clipped'])
def test_dynamic_beta_picks_what_jax_picks(case):
    """Dynamic R-CNN's beta: the (beta_topk x B)-th smallest mean error of
    the positives, the lower index on ties (its gradient goes to that
    element, as JAX's top-k's), 1.0 with fewer positives, clipped to
    [0.01, 1]."""
    rs = np.random.RandomState(7)
    b, s = 2, 16
    err = rs.uniform(0.02, 0.5, (b, s, 4)).astype(np.float32)
    pos = rs.rand(b, s) < 0.8
    if case == 'ties':
        err[:, :, :] = 0.25
    elif case == 'few_positives':
        pos[:] = False
        pos[0, :5] = True
    else:
        err *= 10
    model = tvariants.DynamicRCNN.__new__(tvariants.DynamicRCNN)
    model.beta_topk = 10
    t_err = torch.from_numpy(err).requires_grad_()
    beta = model.dynamic_beta(t_err, torch.from_numpy(pos))
    (grad,) = torch.autograd.grad(beta, t_err)

    def jbeta(e):
        mean_err = jnp.mean(jnp.where(jnp.asarray(pos)[..., None], e,
                                      jnp.inf), axis=-1)
        k = min(10, s)
        small, _ = jax.lax.top_k(-mean_err.reshape(-1), k * b)
        return jnp.clip(jnp.where(jnp.isfinite(-small[-1]), -small[-1],
                                  1.0), 0.01, 1.0)

    ref, ref_grad = jax.value_and_grad(jbeta)(jnp.asarray(err))
    assert float(beta.detach()) == float(ref)
    np.testing.assert_array_equal(grad.numpy(), np.asarray(ref_grad))
    if case == 'few_positives':
        assert float(beta.detach()) == 1.0


def test_several_ranks_refuse_the_variants(tmp_path):
    """The variants' own losses and Dynamic R-CNN's statistics have no
    global-batch form: a multi-rank run raises before the loop makes its
    work dir, as the cascade family's does."""
    for name in ('DoubleHeadRCNN', 'DynamicRCNN', 'GridRCNN',
                 'MaskScoringRCNN', 'PointRend'):
        cfg = tconfig.Config.fromfile(str(ROOT / CONFIGS[name]))
        with pytest.raises(NotImplementedError, match='several ranks'):
            ttrain.train_detector(cfg, str(tmp_path / 'wd'), n_devices=2,
                                  device='cpu')
        assert not (tmp_path / 'wd').exists()
