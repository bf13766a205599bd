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
    raise KeyError(name)


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
        for v in r.values():
            if v.is_floating_point():
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
