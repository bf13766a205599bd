"""Functions that the data-parallel tests run in gloo ranks on the CPU
(`parallel/multihost.py:run_ranks` pickles them by import path, so they
live in a module that imports torch and the port only).

`global_batch_cases(names)` runs each named module that couples rows on
this rank's rows of a seeded global batch, with the layout of the process
group active (or on the whole batch without a process group), and returns
the loss share, the gradients of the row inputs (this rank's rows) and of
the module's parameters, and whatever else the case checks.
"""

from __future__ import annotations

import types
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

PORT = 'unsupervised_domain_adaptation_object_detection_implementation_tpu_torch'

ROWS = 4          # the global batch's rows


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _boxes(rs, shape, extent, lo, hi):
    xy = rs.uniform(0, extent - hi, shape + (2,))
    wh = rs.uniform(lo, hi, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _case(name):
    """(row inputs: dict of global numpy arrays, rows on dim 0; other
    inputs; module or None; fn(rows, other, module) → loss share)."""
    from importlib import import_module
    rs = np.random.RandomState(7)
    b = ROWS
    if name == 'batch_norm':
        norm = import_module(f'{PORT}.models.layers.norm')
        torch.manual_seed(0)
        bn = norm.BatchNorm(5)
        x = rs.standard_normal((b, 5, 6, 7)).astype(np.float32) * 3 + 1
        w = rs.standard_normal((b, 5, 6, 7)).astype(np.float32)

        def fn(r, o, m):
            y = m(r['x'].contiguous(memory_format=torch.channels_last))
            return (y * r['w']).sum()
        return dict(x=x, w=w), {}, bn, fn
    if name in ('grouped_instance_loss', 'split_plain'):
        heads = import_module(f'{PORT}.models.da.heads')
        torch.manual_seed(0)
        mod = torch.nn.ModuleDict(dict(
            fore=heads.InstanceAlignmentHead(feat_dim=16),
            back=heads.InstanceAlignmentHead(feat_dim=16)))
        s = 12
        feats = rs.standard_normal((b, s, 16)).astype(np.float32)
        cls = rs.standard_normal((b, s, 3)).astype(np.float32) * 2
        # each image its own count of valid RoIs
        valid = np.arange(s)[None] < np.array([[12], [3], [9], [6]])
        domain = np.array([0, 1, 0, 1], np.int32)
        if name == 'grouped_instance_loss':
            losses = import_module(f'{PORT}.models.da.losses')

            def fn(r, o, m):
                return losses.grouped_instance_loss(
                    m['fore'], m['back'], r['feats'], r['cls'], r['valid'],
                    r['domain'], k=4)
        else:
            det = import_module(f'{PORT}.models.detectors.da_faster_rcnn')

            def fn(r, o, m):
                fake = types.SimpleNamespace(local_da_fore=m['fore'],
                                             local_da_back=m['back'])
                fake._split_plain_loss = types.MethodType(
                    det.DAFasterRCNN._split_plain_loss, fake)
                return fake._split_plain_loss(r['feats'], r['cls'],
                                              r['valid'], r['domain'])
        return (dict(feats=feats, cls=cls, valid=valid, domain=domain), {},
                mod, fn)
    if name == 'rpn_loss':
        rpn = import_module(f'{PORT}.models.dense_heads.rpn_head')
        anchors = _boxes(rs, (6 * 8 * 3,), 96, 6, 40)
        gt = _boxes(rs, (b, 5), 96, 10, 40)
        gt_valid = np.arange(5)[None] < np.array([[5], [1], [3], [0]])

        def fn(r, o, m):
            return sum(rpn.rpn_loss(
                r['cls'], r['reg'], o['anchors'], r['gt'], r['gt_valid'],
                r['img_shape'], rpn.RPNTrainConfig(num_samples=32),
                loss_weight_mask=(r['domain'] == 0).float(),
                priorities=r['pri']).values())
        return (dict(cls=rs.standard_normal((b, 6, 8, 3)).astype(np.float32),
                     reg=rs.standard_normal((b, 6, 8, 12)).astype(np.float32),
                     gt=gt, gt_valid=gt_valid,
                     img_shape=np.array([[96, 128]] * b, np.int32),
                     domain=np.array([0, 1, 0, 0], np.int32),
                     pri=rs.uniform(0, 1, (b, len(anchors))).astype(
                         np.float32)),
                dict(anchors=anchors), None, fn)
    if name == 'bbox_loss':
        roi = import_module(f'{PORT}.models.roi_heads.standard_roi_head')
        s, c = 8, 3

        def fn(r, o, m):
            sampled = roi.SampledRoIs(
                rois=torch.zeros(r['labels'].shape + (4,)),
                labels=r['labels'], label_valid=r['valid'],
                is_pos=r['is_pos'], reg_targets=r['targets'],
                matched_gt=torch.zeros_like(r['labels']))
            out = 0.0
            for sig in (True, False):
                cfg = roi.RoITrainConfig(use_sigmoid_cls=sig)
                out = out + sum(roi.bbox_loss(
                    r['cls'], r['reg'], sampled, c, cfg,
                    (r['domain'] == 0).float()).values())
            return out
        labels = rs.randint(0, c + 1, (b, s))
        return (dict(cls=rs.standard_normal((b, s, c + 1)).astype(np.float32),
                     reg=rs.standard_normal((b, s, 4 * c)).astype(np.float32),
                     labels=labels,
                     valid=np.arange(s)[None] < np.array([[8], [2], [5], [7]]),
                     is_pos=labels < c,
                     targets=rs.standard_normal((b, s, 4)).astype(np.float32),
                     domain=np.array([0, 0, 1, 0], np.int32)),
                {}, None, fn)
    if name == 'mask_loss':
        mh = import_module(f'{PORT}.models.roi_heads.mask_head')

        def fn(r, o, m):
            return sum(mh.mask_loss(r['logits'], r['targets'], r['labels'],
                                    r['pos'].float()).values())
        return (dict(logits=rs.standard_normal((b, 5, 4, 4, 3)).astype(
                         np.float32),
                     targets=rs.uniform(0, 1, (b, 5, 4, 4)).astype(np.float32),
                     labels=rs.randint(0, 3, (b, 5)),
                     pos=rs.uniform(0, 1, (b, 5)) < np.array(
                         [[0.9], [0.1], [0.5], [0.7]])),
                {}, None, fn)
    if name in ('consistency_loss', 'global_alignment_loss', 'gan_losses'):
        losses = import_module(f'{PORT}.models.da.losses')
        gan = import_module(f'{PORT}.models.losses.gan_loss')

        def fn(r, o, m):
            if name == 'consistency_loss':
                return losses.consistency_loss(r['img'], r['ins'], r['valid'],
                                               r['domain'])
            if name == 'global_alignment_loss':
                return losses.global_alignment_loss(r['logits'], r['domain'])
            return (gan.gan_lsgan_loss(r['img'], True)
                    + gan.gan_lsgan_loss(r['ins'], False)
                    + gan.cycle_consistency_loss(r['img'], r['img'] * 0.5))
        return (dict(img=rs.standard_normal((b, 5, 6, 1)).astype(np.float32),
                     ins=rs.standard_normal((b, 7, 2)).astype(np.float32),
                     logits=rs.standard_normal((b, 2)).astype(np.float32),
                     valid=np.arange(7)[None] < np.array([[7], [1], [4], [2]]),
                     domain=np.array([0, 1, 0, 1], np.int32)),
                {}, None, fn)
    if name in ONE_STAGE_CASES:
        return _one_stage_case(name, rs)
    if name in ANCHOR_HEAD_CASES:
        return _anchor_head_case(name, rs)
    raise KeyError(name)


# the proposal family's and the one-stage core's losses: each couples the
# rows through its global-batch normalizers (GFL's Σ quality with its
# gradient, GHM-C's mean over images)
ONE_STAGE_CASES = ('ga_losses', 'crpn_losses', 'dense_focal_anchor_loss',
                   'fcos_loss', 'atss_loss', 'gfl_loss', 'paa_loss')
# rows that are data, not activations: the loss takes no gradient of them
# (a global normalizer that depends on them, such as FCOS's Σ centerness,
# is a constant of the step, as in the JAX package)
DATA_ROWS = ('gt_boxes', 'rois', 'reg_targets')
STRIDES = (8, 16, 32, 64, 128)
SIZES = ((8, 12), (4, 6), (2, 3), (1, 2), (1, 1))     # a 64x96 canvas


def _one_stage_case(name, rs):
    from importlib import import_module
    b, g = ROWS, 5
    gt = _boxes(rs, (b, g), 64, 8, 40)
    gt_valid = np.arange(g)[None] < np.array([[5], [0], [2], [4]])
    rows = dict(gt_boxes=gt, gt_valid=gt_valid,
                gt_labels=rs.randint(0, 3, (b, g)).astype(np.int64))

    def batch_of(r):
        return dict(gt_bboxes=r['gt_boxes'], gt_valid=r['gt_valid'],
                    gt_labels=r['gt_labels'])

    def normal(*shape, scale=1.0):
        return (rs.standard_normal(shape) * scale).astype(np.float32)

    if name in ('ga_losses', 'crpn_losses'):
        rpn = import_module(f'{PORT}.models.detectors.rpn_detectors')
        strides, sizes = STRIDES[:2], SIZES[:2]
        centers, svec, levels = (t.numpy() for t in rpn._fpn_grid(
            strides, sizes, 'cpu'))
        n = len(centers)
        wh = rs.uniform(10, 60, (b, n, 2)).astype(np.float32)
        guided = np.concatenate([centers - wh / 2, centers + wh / 2], -1)
        if name == 'ga_losses':
            fake = types.SimpleNamespace(strides=strides, octave_base=2.0,
                                         center_ratio=0.5, num_classes=3)

            def fn(r, o, m):
                bt = batch_of(r)
                losses = rpn._GABase._ga_losses(
                    fake, r['loc'], r['anchors'], o['centers'], o['levels'],
                    bt)
                losses.update(rpn._GABase._rpn_losses(
                    fake, r['cls1'], r['reg'], r['anchors'].detach(), bt))
                losses.update(rpn.GARetinaNet._retina_losses(
                    fake, r['cls'], r['reg'], r['anchors'], bt))
                return sum(losses.values())
            rows.update(loc=normal(b, n), anchors=guided,
                        cls1=normal(b, n, 1), cls=normal(b, n, 3),
                        reg=normal(b, n, 4, scale=0.3))
            return rows, dict(centers=centers, levels=levels), None, fn
        anchors0 = np.concatenate([centers - svec[:, None] * 2,
                                   centers + svec[:, None] * 2], -1)

        def fn(r, o, m):
            return sum(rpn.CascadeRPN._crpn_losses(
                None, r['reg1'], r['cls2'], r['reg2'], o['anchors0'],
                r['anchors1'], batch_of(r), 0.7).values())
        rows.update(reg1=normal(b, n, 4, scale=0.3), cls2=normal(b, n),
                    reg2=normal(b, n, 4, scale=0.3), anchors1=guided)
        return rows, dict(anchors0=anchors0), None, fn
    anchor_head = import_module(f'{PORT}.models.dense_heads.anchor_head')
    if name == 'dense_focal_anchor_loss':
        cfg = anchor_head.MultiAnchorConfig()
        anchors = cfg.flat_anchors(SIZES).astype(np.float32)
        n = len(anchors)

        def fn(r, o, m):
            return sum(sum(anchor_head.dense_focal_anchor_loss(
                r['cls'], r['reg'], o['anchors'], r['gt_boxes'],
                r['gt_labels'], r['gt_valid'], r['img_shape'], 3,
                anchor_head.DenseAnchorTrainConfig(loss_cls=kind)).values())
                for kind in ('focal', 'ghm'))
        rows.update(cls=normal(b, n, 3), reg=normal(b, n, 4, scale=0.3),
                    img_shape=np.array([[64, 96], [64, 96], [48, 80],
                                        [64, 70]], np.int32))
        return rows, dict(anchors=anchors), None, fn
    if name == 'fcos_loss':
        fcos = import_module(f'{PORT}.models.detectors.fcos')
        pts, strs, rngs = (t.numpy() for t in fcos.fcos_points(SIZES,
                                                               STRIDES))
        n = len(pts)

        def fn(r, o, m):
            return sum(sum(fcos.fcos_loss(
                r['cls'], r['reg'], r['ctr'], o['pts'], o['strs'],
                o['rngs'], r['gt_boxes'], r['gt_labels'], r['gt_valid'], 3,
                center_sampling=cs).values()) for cs in (False, True))
        rows.update(cls=normal(b, n, 3), ctr=normal(b, n, 1),
                    reg=np.exp(normal(b, n, 4, scale=0.5)))
        return rows, dict(pts=pts, strs=strs, rngs=rngs), None, fn
    anchors, nla = anchor_head.level_anchors(STRIDES, (1.0,), (4.0,), SIZES,
                                             'cpu')
    anchors = anchors.numpy()
    n = len(anchors)
    if name == 'atss_loss':
        atss = import_module(f'{PORT}.models.detectors.atss')

        def fn(r, o, m):
            return sum(atss.atss_loss(
                r['cls'], r['reg'], r['ctr'], o['anchors'], nla, r['gt_boxes'],
                r['gt_labels'], r['gt_valid'], 3).values())
        rows.update(cls=normal(b, n, 3), reg=normal(b, n, 4, scale=0.3),
                    ctr=normal(b, n, 1))
        return rows, dict(anchors=anchors), None, fn
    if name == 'gfl_loss':
        gfl = import_module(f'{PORT}.models.detectors.gfl')
        strides = np.repeat(np.float32(STRIDES), nla)

        def fn(r, o, m):
            return sum(gfl.gfl_loss(
                r['cls'], r['reg'], o['anchors'], nla, o['strides'],
                r['gt_boxes'], r['gt_labels'], r['gt_valid'], 3, 16).values())
        rows.update(cls=normal(b, n, 3), reg=normal(b, n, 68, scale=2.0))
        return rows, dict(anchors=anchors, strides=strides), None, fn
    paa = import_module(f'{PORT}.models.detectors.paa')

    def fn(r, o, m):
        return sum(paa.paa_loss(r['cls'], r['reg'], r['iou'], o['anchors'],
                                nla, batch_of(r), 3, 4).values())
    rows.update(cls=normal(b, n, 3), reg=normal(b, n, 4, scale=0.2),
                iou=normal(b, n, 1))
    return rows, dict(anchors=anchors), None, fn


# the RetinaNet-derived heads' losses: FreeAnchor's Σ gt, FSAF's,
# FoveaBox's, SABL's and PISA's positive counts, a SABL stage's sampled
# and positive counts and PISA's two-stage sampled count are global-batch
# normalizers (ISR-P and CARL renormalize within each image)
ANCHOR_HEAD_CASES = ('free_anchor_loss', 'fsaf_loss', 'fovea_loss',
                     'sabl_retina_loss', 'sabl_stage_loss',
                     'pisa_anchor_loss', 'pisa_roi_losses')


def _anchor_head_case(name, rs):
    from importlib import import_module
    b, g = ROWS, 5
    gt = _boxes(rs, (b, g), 64, 8, 40)
    gt_valid = np.arange(g)[None] < np.array([[5], [0], [2], [4]])
    labels = rs.randint(0, 3, (b, g)).astype(np.int64)
    rows = dict(gt_boxes=gt, gt_valid=gt_valid, gt_labels=labels)

    def normal(*shape, scale=1.0):
        return (rs.standard_normal(shape) * scale).astype(np.float32)

    anchor_head = import_module(f'{PORT}.models.dense_heads.anchor_head')
    if name in ('free_anchor_loss', 'pisa_anchor_loss'):
        anchors = anchor_head.MultiAnchorConfig().flat_anchors(SIZES).astype(
            np.float32)
        n = len(anchors)
        if name == 'free_anchor_loss':
            fa = import_module(f'{PORT}.models.detectors.free_anchor')

            def fn(r, o, m):
                return sum(fa.free_anchor_loss(
                    r['cls'], r['reg'], o['anchors'], r['gt_boxes'],
                    r['gt_labels'], r['gt_valid'], 3).values())
        else:
            pisa = import_module(f'{PORT}.models.detectors.pisa')

            def fn(r, o, m):
                return sum(pisa.pisa_anchor_loss(
                    r['cls'], r['reg'], o['anchors'], r['gt_boxes'],
                    r['gt_labels'], r['gt_valid'], r['img_shape'],
                    3).values())
        rows.update(cls=normal(b, n, 3), reg=normal(b, n, 4, scale=0.3),
                    img_shape=np.array([[64, 96], [64, 96], [48, 80],
                                        [64, 70]], np.int32))
        return rows, dict(anchors=anchors), None, fn
    if name == 'fsaf_loss':
        fsaf = import_module(f'{PORT}.models.detectors.fsaf')
        pts, strs, lvl = (t.numpy() for t in fsaf.fsaf_points(SIZES,
                                                              STRIDES))

        def fn(r, o, m):
            return sum(fsaf.fsaf_loss(
                r['cls'], r['reg'], o['pts'], o['strs'], o['lvl'], 5,
                r['gt_boxes'], r['gt_labels'], r['gt_valid'], 3).values())
        rows.update(cls=normal(b, len(pts), 3),
                    reg=np.exp(normal(b, len(pts), 4, scale=0.5)) * 0.3)
        return rows, dict(pts=pts, strs=strs, lvl=lvl), None, fn
    if name == 'fovea_loss':
        fovea = import_module(f'{PORT}.models.detectors.fovea')
        grid = [t.numpy() for t in fovea.fovea_grid(SIZES, STRIDES)]

        def fn(r, o, m):
            return sum(fovea.fovea_loss(
                r['cls'], r['reg'], o['pts'], o['base'], o['lo'], o['hi'],
                r['gt_boxes'], r['gt_labels'], r['gt_valid'], 3).values())
        rows.update(cls=normal(b, len(grid[0]), 3),
                    reg=normal(b, len(grid[0]), 4))
        return rows, dict(zip(('pts', 'base', 'lo', 'hi'), grid)), None, fn
    sabl = import_module(f'{PORT}.models.detectors.sabl_retina')
    if name == 'sabl_retina_loss':
        anchors, _ = anchor_head.level_anchors(STRIDES, (1.0,), (4,), SIZES,
                                               'cpu')
        n = len(anchors)

        def fn(r, o, m):
            return sum(sabl.sabl_retina_loss(
                r['cls'], r['bc'], r['bo'], o['anchors'], r['gt_boxes'],
                r['gt_labels'], r['gt_valid'], 3).values())
        rows.update(cls=normal(b, n, 3), bc=normal(b, n, 28),
                    bo=normal(b, n, 28, scale=0.5))
        return rows, dict(anchors=anchors.numpy()), None, fn
    # a stage's sampled RoIs as a data row: 24 slots an image, some
    # padded, some positive, each matched to a valid gt where it has one
    roi = import_module(f'{PORT}.models.roi_heads.standard_roi_head')
    s = 24
    valid = np.arange(s)[None] < np.array([[24], [10], [17], [3]])
    is_pos = valid & (rs.uniform(0, 1, (b, s)) < 0.4) & gt_valid.any(1)[:, None]
    matched = rs.randint(0, 5, (b, s)) % np.maximum(gt_valid.sum(1), 1)[:, None]
    cls_lbl = np.where(is_pos, np.take_along_axis(labels, matched, 1), 3)
    rows.update(rois=_boxes(rs, (b, s), 64, 8, 40), labels=cls_lbl,
                label_valid=valid, is_pos=is_pos,
                reg_targets=normal(b, s, 4), matched=matched,
                cls=normal(b, s, 4))

    def sampled(r):
        return roi.SampledRoIs(r['rois'], r['labels'], r['label_valid'],
                               r['is_pos'], r['reg_targets'], r['matched'])
    if name == 'sabl_stage_loss':
        def fn(r, o, m):
            return sum(sabl.sabl_stage_loss(
                r['cls'], r['bc'], r['bo'], sampled(r),
                r['gt_boxes']).values())
        rows.update(bc=normal(b, s, 28), bo=normal(b, s, 28, scale=0.5))
        return rows, {}, None, fn
    pisa = import_module(f'{PORT}.models.detectors.pisa')

    def fn(r, o, m):
        return sum(pisa.pisa_roi_losses(r['cls'], r['reg'], sampled(r),
                                        r['gt_boxes'], 3).values())
    rows.update(reg=normal(b, s, 12, scale=0.3))
    return rows, {}, None, fn


def global_batch_cases(names: List[str]) -> Dict:
    """Each case on this rank's rows (see the module docstring)."""
    from importlib import import_module
    mesh = import_module(f'{PORT}.parallel.mesh')
    layout = mesh.make_layout(1) if dist.is_initialized() else None
    lo, hi = 0, ROWS
    if layout is not None:
        per = ROWS // layout.data.size
        lo, hi = layout.data.rank * per, (layout.data.rank + 1) * per
    out = {}
    for name in names:
        rows, other, module, fn = _case(name)
        r = {k: _t(v[lo:hi]) for k, v in rows.items()}
        for k, v in r.items():
            if v.is_floating_point() and k not in DATA_ROWS:
                v.requires_grad_(True)
        o = {k: _t(v) for k, v in other.items()}
        params = dict(module.named_parameters()) if module is not None else {}
        torch.manual_seed(5)             # dropout draws alike everywhere
        with mesh.use_layout(layout):
            loss = fn(r, o, module)
            wrt = [v for v in r.values() if v.requires_grad] + \
                list(params.values())
            grads = torch.autograd.grad(loss, wrt, allow_unused=True)
        names_wrt = [k for k, v in r.items() if v.requires_grad] + \
            [f'param.{n}' for n in params]
        res = dict(loss=loss.detach(),
                   grads={n: (g if g is not None else torch.zeros_like(w))
                          for n, g, w in zip(names_wrt, grads, wrt)})
        if module is not None:
            res['buffers'] = dict(module.named_buffers())
        out[name] = res
    return out


def cases_and_draws(names: List[str]) -> Dict:
    """`global_batch_cases(names)` and `sampler_and_dropout_draws()` in
    one rank launch."""
    return dict(cases=global_batch_cases(names),
                draws=sampler_and_dropout_draws())


def sampler_and_dropout_draws() -> Dict:
    """This rank's rows of the samplers' priorities and of a dropout mask
    (channels_last 4D and 2D), drawn as the loop seeds them."""
    from importlib import import_module
    mesh = import_module(f'{PORT}.parallel.mesh')
    samplers = import_module(f'{PORT}.core.bbox.samplers')
    batch = import_module(f'{PORT}.parallel.batch')
    layout = mesh.make_layout(1) if dist.is_initialized() else None
    per = ROWS if layout is None else ROWS // layout.data.size
    agi = torch.zeros((per, 50), dtype=torch.long)
    agi[:, ::7] = 1
    drop = batch.Dropout(0.5).train()
    out = {}
    with mesh.use_layout(layout):
        gen = torch.Generator().manual_seed(11)
        out['pos_mask'] = samplers.random_sample(agi, 16, 0.25,
                                                 generator=gen).pos_mask
        torch.manual_seed(3)
        out['drop4d'] = drop(torch.ones((per, 4, 3, 5)).contiguous(
            memory_format=torch.channels_last))
        out['drop2d'] = drop(torch.ones((per, 9)))
    return out


def _equal_trees(got: Dict, ref: Dict) -> List[str]:
    """The names under params, momentum, EMA and buffers where two
    checkpoint payloads differ in a bit (or in their names)."""
    bad = []
    for key in ('params', 'momentum', 'ema_params', 'buffers'):
        if set(got[key]) != set(ref[key]):
            bad.append(key)
            continue
        bad += [f'{key}.{n}' for n, v in ref[key].items()
                if not torch.equal(got[key][n], v)]
    return bad


def tp_shards(ckpt_path: str) -> Dict:
    """On a layout of one data rank and a model axis of every rank, the
    checks of the Megatron split, made on the rank (the tensors stay
    there): the checkpoint at `ckpt_path` restored and split as a resumed
    run restores it; each split parameter, its momentum and its EMA hold
    this rank's chunk of the checkpoint's tensor, the others stay whole,
    and the payload gathered back equals the checkpoint bit for bit."""
    from importlib import import_module
    import os
    mesh = import_module(f'{PORT}.parallel.mesh')
    sh = import_module(f'{PORT}.parallel.shardings')
    train = import_module(f'{PORT}.apis.train')
    ckpt = import_module(f'{PORT}.utils.checkpoint')
    cfg_mod = import_module(f'{PORT}.utils.config')
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = cfg_mod.Config.fromfile(
        os.path.join(root, 'configs/da/faster_rcnn_r18_tiny_fixture.py'))
    cfg.merge_from_dict({'ema': dict(momentum=0.9995)})
    layout = mesh.make_layout(dist.get_world_size())
    saved = ckpt.load_checkpoint(ckpt_path, 'cpu')
    tr = train.init_trainer(cfg, device='cpu', steps_per_epoch=1,
                            layout=layout)
    state = ckpt.restore_train_state(tr.model, tr.state, saved)
    sh.shard_train_state_(tr.model, state, tr.optimizer, layout)
    names = sorted(n for n in state.params if sh.tp_split_dim(
        n, tuple(saved['params'][n].shape)) is not None)
    chunks_ok = {}
    for n in names:
        dim = 1 if 'shared_fc2' in n else 0
        pairs = ((state.params[n].detach(), saved['params'][n]),
                 (state.opt_state.momentum[n], saved['momentum'][n]),
                 (state.ema_params[n], saved['ema_params'][n]))
        chunks_ok[n] = all(torch.equal(
            shard, full.chunk(layout.model.size, dim)[layout.model.rank])
            for shard, full in pairs)
    whole_ok = all(state.params[n].shape == saved['params'][n].shape
                   for n in state.params if n not in names)
    restored = sh.gather_payload(ckpt.train_state_dict(tr.model, state),
                                 layout)
    return dict(names=names, chunks_ok=chunks_ok, whole_ok=whole_ok,
                restored_bad=_equal_trees(restored, saved),
                restored_step=restored['step'], saved_step=saved['step'],
                model_split=sorted(tr.optimizer.model_split[0]),
                head_group=tr.model.bbox_head.model_group is not None)
