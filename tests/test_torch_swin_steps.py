"""Two AdamW train steps of DeepAlign-Swin (`configs/da/deepalign_swin_t_
c2f.py`: `DAFasterRCNN_Deep` on a Swin-T trunk tapped at stage 2, stride
16, 384 channels) in the port against the JAX package's `make_train_step`,
at Swin-T width on the tiny fixture's 128x192 canvas, heads and proposal
counts, with AdamW at the config's weight decay (0.05), a global-norm
clip, the EMA and the NaN guard. The lr is 1e-5, the config's 1e-4 scaled
down: Adam's first update is ±lr on every element whose gradient lies
within f32 rounding of zero, and the sign there is set by each side's
summation order; at 1e-4 those flips alone move the second step's global
DA loss by 5.5e-4 relative on this canvas (measured), at 1e-5 by a tenth
of that.

Both sides start from the same seeded JAX weights, run with dropout off
and the same sampler priorities; the JAX step is compiled without XLA:CPU's
algebraic simplifier (`test_torch_train.py`). Tolerances: per-term losses
within 1e-4 relative; batch statistics within 1e-4 of scale; Adam's two
moments within 1e-3 of the largest entry of the whole moment (they carry
the second step's gradients, taken where those sign flips left the
parameters; measured 6.7e-4 and 5.6e-4). The update itself (p − p0, and
the EMA's ema − p0) is held at its own scale, which at this lr lies far
below the parameters' (`_check_updates`).
"""

import importlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch

from .test_torch_da_variants import (DET_KEYS, HW, KEYS, _jax_model,
                                     _jax_variables, check_losses)
from .test_torch_train import (_converted, _demo_batch,
                               _jax_fixed_samplers, _no_dropout, _tiny_cfg)
from .torch_port_utils import JAX_PKG, PORT_PKG

SWIN_BACKBONE = dict(type='DAResNet', trunk_type='swin', out_stride=16,
                     frozen_stages=1)
SEED = 0

jts = importlib.import_module(f'{JAX_PKG}.apis.train_state')
ttrain = importlib.import_module(f'{PORT_PKG}.apis.train')
tbuilder = importlib.import_module(f'{PORT_PKG}.models.builder')
tswin = importlib.import_module(f'{PORT_PKG}.models.backbones.swin')


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, tol, floor, name):
    """|got − ref| within `tol` of max(floor, max |ref|) (`_close_scaled`
    in torch, which is faster over Swin-T's 70 M parameters)."""
    scale = max(floor, ref.abs().max().item())
    err = (got - ref).abs().max().item()
    assert err <= tol * scale, f'{name}: {err:.3e} > {tol} x {scale:.3e}'


def _check_updates(start, got, ref, g1, g2, nu, tnu, name, decay_ulps):
    """The update of two Adam steps, `got` − `start` against `ref` −
    `start` (the JAX side's), per tensor:

    - a tensor without a gradient on either side (behind the trunk's
      stop-gradient: zero moments) moves by AdamW's decoupled decay alone,
      lr·wd ≈ 2.5e-7 of the weight over the two steps, 2–4 f32 ulps: held
      within `decay_ulps` ulps of the weight (0 for the parameters, which
      both sides compute as p − lr·(wd·p); measured equal, and a decay 1%
      off changes 1605 elements here), so a decay missing, doubled or not
      scaled by the lr fails;
    - elsewhere an element is compared where its JAX gradient is resolved
      at both steps: at least 1e-3 of the whole first gradient's largest
      entry, the moments' own tolerance, and of one sign at both steps;
      within 1e-2 of the tensor's JAX update after 2 ulps of the weight
      (each side rounds p0 + update there, and a LayerNorm scale is 1e5
      times its update; measured 1.96e-3). Adam divides each element's
      moment by its root mean square, so a gradient inside the moments'
      tolerance of zero gives an update of either sign (0.08% of the
      elements flip at the first step), and one whose two steps disagree
      in sign an update near 0 set by their difference.

    Returns (compared, excluded) element counts of the tensors with a
    gradient."""
    whole = max(g.abs().max().item() for g in g1.values())
    eps = torch.finfo(torch.float32).eps
    compared = excluded = 0
    for k, p0 in start.items():
        upd, ref_upd = got[k] - p0, ref[k] - p0
        weight = torch.maximum(p0.abs(), ref[k].abs())
        if not (nu[k].any() or tnu[k].any()):
            ulps = ((got[k] - ref[k]).abs() / (eps * weight)).max().item()
            assert ulps <= decay_ulps, f'{name} {k} decay: {ulps:.2f} ulps'
            continue
        err = ((upd - ref_upd).abs() - 2 * eps * weight).clamp(min=0)
        scale = ref_upd.abs().max().item()
        keep = (g1[k].abs() >= 1e-3 * whole) & \
            (g2[k].abs() >= 1e-3 * whole) & (g1[k].sign() == g2[k].sign())
        compared += int(keep.sum())
        excluded += keep.numel() - int(keep.sum())
        if keep.any():
            worst = err[keep].max().item()
            assert worst <= 1e-2 * scale, \
                f'{name} {k}: {worst:.3e} > 1e-2 x {scale:.3e}'
    return compared, excluded


def _adam_moments(opt_state):
    """(mu, nu) of the Adam state inside an optax chain's state."""
    found = []

    def walk(node):
        if hasattr(node, 'mu') and hasattr(node, 'nu'):
            found.append(node)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, tuple):
            for v in node:
                walk(v)
    walk(opt_state)
    assert len(found) == 1, found
    return found[0].mu, found[0].nu


def test_deepalign_swin_adamw_steps_match():
    cfg = _tiny_cfg()
    cfg.merge_from_dict({
        'model.type': 'DAFasterRCNN_Deep', 'model.backbone': SWIN_BACKBONE,
        'optimizer': dict(type='AdamW', lr=1e-5, weight_decay=0.05)})
    for dataset in cfg.data.train.datasets:
        for t in dataset.pipeline:
            if t['type'] == 'Pad':
                t['size'] = HW
    model = _jax_model('DAFasterRCNN_Deep', backbone_type='swin',
                       featmap_stride=16)
    batch = _demo_batch(h=HW[0], w=HW[1])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jvars = _jax_variables(model, jbatch, SEED)
    trainer = ttrain.init_trainer(cfg, variables=jvars, device='cpu',
                                  steps_per_epoch=1)
    assert isinstance(trainer.model.backbone.trunk, tswin.SwinTransformer)
    assert trainer.spec.opt_type == 'adamw'
    for m in trainer.model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0

    tbatch = {k: _t(v) for k, v in batch.items()}
    start = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    rpn_key, roi_key = jax.random.PRNGKey(21), jax.random.PRNGKey(22)
    anchors = (HW[0] // 16) * (HW[1] // 16) * 6
    cands = batch['gt_bboxes'].shape[1] + 64
    pri = dict(rpn=_t(jax.random.uniform(rpn_key, (anchors,))).expand(2, -1),
               rcnn=_t(jax.random.uniform(roi_key, (cands,))).expand(2, -1))
    jmetrics, tmetrics = [], []
    state = trainer.state
    with _jax_fixed_samplers(rpn_key, roi_key), \
            fnn.intercept_methods(_no_dropout):
        spec = jts.OptimizerSpec(**trainer.spec._asdict())
        jstate, tx = jts.create_train_state(model, jvars, spec,
                                            frozen_stages=1, ema=True)
        jstep = jax.jit(jts.make_train_step(
            model, tx, skip_nonfinite=True, ema_momentum=0.9995))
        jstep = jstep.lower(jstate, jbatch, jax.random.PRNGKey(3)).compile(
            compiler_options={'xla_disable_hlo_passes': 'algsimp'})
        for _ in range(2):
            jstate, m = jstep(jstate, jbatch, jax.random.PRNGKey(3))
            jmetrics.append(jax.tree_util.tree_map(np.asarray, m))
            state, m = trainer.step(state, tbatch, sampler_priorities=pri)
            tmetrics.append({k: v.numpy() for k, v in m.items()})
            if len(jmetrics) == 1:
                mu1, _ = _adam_moments(jax.device_get(jstate.opt_state))
        jstate = jax.device_get(jstate)
    check_losses(dict(jmetrics=jmetrics, tmetrics=tmetrics),
                 DET_KEYS | KEYS['DAFasterRCNN_Deep'])

    tmodel = trainer.model
    ref = _converted({'params': jstate.params,
                      'batch_stats': jstate.batch_stats}, tmodel)
    params = dict(tmodel.named_parameters())
    assert set(ref) == set(tmodel.state_dict())
    for k, v in tmodel.state_dict().items():
        if k in params:                 # AdamW's decay moves every one
            assert not torch.equal(v, start[k]), k
        else:
            _close(v, ref[k], 1e-4, 1.0, k)
    mu, nu = _adam_moments(jstate.opt_state)
    assert state.opt_state.count == 2
    mu1, mu, nu = (_converted({'params': t}, tmodel) for t in (mu1, mu, nu))
    for ours, theirs in ((state.opt_state.momentum, mu),
                         (state.opt_state.nu, nu)):
        assert set(ours) == set(theirs) == set(params)
        whole = max(t.abs().max().item() for t in theirs.values())
        for k, m in ours.items():
            _close(m, theirs[k], 1e-3, whole, k)
    # the clipped gradients of the two steps, from the first moment
    g1 = {k: m / 0.1 for k, m in mu1.items()}
    g2 = {k: (mu[k] - 0.9 * mu1[k]) / 0.1 for k in mu}
    p0 = {k: start[k] for k in params}
    ema = _converted({'params': jstate.ema_params}, tmodel)
    # the EMA, ema·m + p·(1 − m), rounds otherwise than JAX's: 1 ulp
    counts = [_check_updates(p0, got, want, g1, g2, nu, state.opt_state.nu,
                             name, ulps)
              for name, got, want, ulps in (
                  ('update', {k: p.detach() for k, p in params.items()},
                   ref, 0),
                  ('EMA', state.ema_params, ema, 1))]
    compared, excluded = counts[0]
    print(f'updates compared on {compared} elements, {excluded} excluded')
    assert 4 * compared >= compared + excluded, (compared, excluded)
    # the stop-gradient after stage 0: no gradient, so no moments there
    assert not state.opt_state.nu['backbone.trunk.patch_embed.weight'].any()
    assert state.opt_state.nu['backbone.trunk.stage1.block0.mlp_fc1.weight'] \
        .any()
