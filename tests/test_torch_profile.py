"""The train-step profile reads its stages from the ranges the step opens:
one tiny-fixture step on the CPU must show every stage of the DAF step. The
serving profile's stages run on either detector through the surface they
share."""

import importlib
import pathlib

import numpy as np
import pytest
import torch

from .torch_port_utils import NARROW_OPTIONS, PORT_PKG

ROOT = pathlib.Path(__file__).resolve().parent.parent

profile_train = importlib.import_module(f'{PORT_PKG}.tools.profile_train')
profile_serving = importlib.import_module(
    f'{PORT_PKG}.tools.profile_serving')
apis = importlib.import_module(f'{PORT_PKG}.apis')
tconfig = importlib.import_module(f'{PORT_PKG}.utils.config')


def test_profile_train_reads_every_stage_of_the_step(tmp_path):
    result = profile_train.main([
        '--device', 'cpu', '--size', '64', '96', '--steps', '1',
        '--config', str(ROOT / 'configs/da/faster_rcnn_r18_tiny_fixture.py'),
        '--cfg-options', *NARROW_OPTIONS,
        '--out', str(tmp_path / 'profile.json')])
    assert list(result['stage_host_ms']) == [
        'trunk_and_grl_heads', 'rpn_head_and_loss', 'proposals',
        'roi_sampling', 'roi_align_fwd', 'bbox_head_and_loss', 'da_losses',
        'backward', 'sgd_guard_ema']
    assert all(ms > 0 for ms in result['stage_host_ms'].values())
    # the stages lie inside the profiled step
    assert sum(result['stage_host_ms'].values()) <= \
        result['profiled_wall_ms']
    assert (tmp_path / 'profile.json').exists()


def test_profile_train_reads_every_stage_of_the_fpn_step(tmp_path):
    """The same profile of a tiny FPN detector (the Cityscapes FPN config
    with an R18 trunk and a 64-channel neck): its step opens the FPN
    stages."""
    cfg = tmp_path / 'fpn_tiny.py'
    cfg.write_text(
        f"_base_ = [{str(ROOT / 'configs/cityscapes/faster_rcnn_r50_fpn_1x_cityscapes.py')!r}]\n"
        'model = dict(backbone_depth=18, neck_channels=64, num_classes=2,\n'
        '             rpn_proposal_cfg=dict(nms_pre=512, max_per_img=128),\n'
        '             roi_train_cfg=dict(num_samples=64))\n')
    result = profile_train.main([
        '--device', 'cpu', '--size', '96', '160', '--steps', '1',
        '--config', str(cfg), '--out', str(tmp_path / 'profile.json')])
    assert list(result['stage_host_ms']) == [
        'trunk_and_neck', 'rpn_head_and_loss', 'proposals', 'roi_sampling',
        'roi_align_fwd', 'bbox_head_and_loss', 'backward', 'sgd_guard_ema']
    assert all(ms > 0 for ms in result['stage_host_ms'].values())


def _tiny_fpn_cfg():
    cfg = tconfig.Config.fromfile(
        str(ROOT / 'configs/cityscapes/faster_rcnn_r50_fpn_1x_cityscapes.py'))
    cfg.merge_from_dict({
        'model.backbone_depth': 18, 'model.neck_channels': 64,
        'model.num_classes': 2,
        'model.rpn_test_cfg': dict(nms_pre=256, max_per_img=64),
        'data.test.pipeline': [dict(type='MultiScaleFlipAug',
                                    img_scale=(192, 128))]})
    return cfg


@pytest.mark.parametrize('detector', ['dc5', 'fpn'])
def test_profile_serving_stages_run_on_either_detector(detector):
    """`profile_serving`'s stages (trunk, RPN head, proposals, RoI head,
    and RoIAlign and Shared2FC alone) on a tiny DC5 and a tiny FPN detector
    on the CPU: the stage RoIAlign gives the features that the RoI head's
    own extractor gives, one row per proposal, and Shared2FC scores them."""
    cfg = str(ROOT / 'configs/da/faster_rcnn_r18_tiny_fixture.py') \
        if detector == 'dc5' else _tiny_fpn_cfg()
    bundle = apis.init_detector(cfg, device='cpu', seed=0)
    rs = np.random.RandomState(0)
    imgs = [rs.randint(0, 256, (100, 150, 3), dtype=np.uint8)
            for _ in range(2)]
    batch, _ = apis.prepare_batch(bundle, imgs)
    model, outs = bundle.model, {}
    with torch.inference_mode():
        out = None
        for name, fn in profile_serving._stages(model, batch):
            out = outs[name] = fn(out)
        maps, props, valid = outs['roi_head']
        ref = model.roi_extract(maps, props)
    assert list(outs) == ['trunk', 'rpn_head', 'proposals', 'roi_head',
                          'roi_head.roi_align', 'roi_head.bbox_head']
    assert valid.any()
    feats = outs['roi_head.roi_align']
    assert feats.shape[:2] == props.shape[:2]
    torch.testing.assert_close(feats, ref, rtol=0, atol=0)
    cls = outs['roi_head.bbox_head'][0]
    assert cls.shape[:2] == props.shape[:2]
    assert cls.shape[-1] == model.num_classes + 1
    assert torch.isfinite(cls).all()


def _tiny_mask_cfg(path, **model):
    cfg = tconfig.Config.fromfile(str(ROOT / path))
    cfg.merge_from_dict({f'model.{k}': v for k, v in model.items()})
    cfg.merge_from_dict({
        'model.backbone_depth': 18, 'model.num_classes': 2,
        'model.rpn_proposal_cfg': dict(nms_pre=256, max_per_img=64),
        'model.rpn_test_cfg': dict(nms_pre=256, max_per_img=64),
        'model.roi_train_cfg': dict(num_samples=32),
        'data.test.pipeline': [dict(type='MultiScaleFlipAug',
                                    img_scale=(192, 128))]})
    return cfg


MASK_CFGS = {
    'mask': ('configs/cityscapes/mask_rcnn_r50_fpn_1x_cityscapes.py',
             dict(neck_channels=64)),
    'c4': ('configs/mask_rcnn/mask_rcnn_r50_caffe_c4_1x.py', {})}


@pytest.mark.parametrize('detector', sorted(MASK_CFGS))
def test_profile_serving_stages_run_on_the_mask_detectors(detector):
    """The serving stages of a tiny Mask R-CNN (FPN) and Mask R-CNN C4 add
    the mask branch after the RoI head; its masks are `predict`'s, and C4's
    box-head stage runs res5 first (`roi_box_head`)."""
    path, model_kwargs = MASK_CFGS[detector]
    bundle = apis.init_detector(_tiny_mask_cfg(path, **model_kwargs),
                                device='cpu', seed=0)
    rs = np.random.RandomState(0)
    imgs = [rs.randint(0, 256, (100, 150, 3), dtype=np.uint8)
            for _ in range(2)]
    batch, _ = apis.prepare_batch(bundle, imgs)
    model, names, results = bundle.model, [], {}
    with torch.inference_mode():
        out = None
        for name, fn in profile_serving._stages(model, batch, results):
            out = fn(out)
            names.append(name)
        ref = model.predict(batch)
    assert names == ['trunk', 'rpn_head', 'proposals', 'roi_head',
                     'mask_branch', 'roi_head.roi_align',
                     'roi_head.bbox_head']
    for k, v in ref.items():
        torch.testing.assert_close(results[k], v, rtol=0, atol=0)
    assert out[0].shape[-1] == model.num_classes + 1


@pytest.mark.parametrize('detector', sorted(MASK_CFGS))
def test_profile_train_reads_the_mask_stages(detector, tmp_path):
    """A tiny mask detector's step opens the mask branch's stages (and
    C4's res5 head), each with host time."""
    path, model_kwargs = MASK_CFGS[detector]
    cfg = tmp_path / 'tiny.py'
    kwargs = dict(model_kwargs, backbone_depth=18, num_classes=2,
                  rpn_proposal_cfg=dict(nms_pre=512, max_per_img=128),
                  roi_train_cfg=dict(num_samples=64))
    cfg.write_text(f"_base_ = [{str(ROOT / path)!r}]\n"
                   f'model = dict(**{kwargs!r})\n')
    result = profile_train.main([
        '--device', 'cpu', '--size', '96', '160', '--steps', '1',
        '--config', str(cfg), '--out', str(tmp_path / 'profile.json')])
    head = ['trunk_and_neck'] if detector == 'mask' else ['trunk']
    mid = ['mask_roi_align_fwd'] if detector == 'mask' else []
    res5 = [] if detector == 'mask' else ['res5_shared_head']
    assert list(result['stage_host_ms']) == head + [
        'rpn_head_and_loss', 'proposals', 'roi_sampling', 'roi_align_fwd',
        *res5, 'bbox_head_and_loss', *mid, 'mask_targets',
        'mask_head_and_loss', 'backward', 'sgd_guard_ema']
    assert all(ms > 0 for ms in result['stage_host_ms'].values())
