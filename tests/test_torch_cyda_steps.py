"""`predict` and two train steps of the tiny CyDA and CyCADA detectors
(one generator block, 128x192) against the JAX package's
`make_gan_train_step`, both optimizer states compared (split off
`test_torch_cyda.py` to keep each file near two minutes on one worker);
the tolerances are in `test_gan_train_steps_match`."""

import numpy as np
import pytest
import torch

from .test_torch_cyda import GAN_KEYS, SEED, cyda_variables  # noqa: F401
from .test_torch_da_variants import (DET_KEYS, check_losses, check_predict,
                                     check_state, two_steps)


@pytest.fixture(scope='module', params=['CyDAFasterRCNN', 'CyCADA'])
def gan_run(request, cyda_variables):
    run = two_steps(request.param, SEED, {'model.gen_blocks': 1},
                    dict(gen_blocks=1), variables=cyda_variables)
    run['det_type'] = request.param
    yield run
    del run


def test_gan_predict_matches(gan_run):
    """Both serve as plain Faster R-CNN on untranslated images."""
    check_predict(gan_run)


def test_gan_train_steps_match(gan_run):
    """The two-group step against `make_gan_train_step`: loss terms within
    1e-4 relative, the parameters within 1e-4 of scale and both
    optimizers' momentum.

    The CycleGAN's float32 gradients are ill-conditioned at this size:
    each side's float32 gradient of a generator weight is up to ~3% from
    its own float64 one (the instance norms' backward cancels a
    near-uniform upstream gradient), while in float64 the two sides agree
    to 1e-10 (`test_cyclegan_gradients_match_in_float64`); the worst
    generator or discriminator momentum here is ~2.1e-2 of scale. CyDA's
    detector then trains on translated images whose second-step values
    inherit that, and its momentum differs by up to ~2.6e-3 of scale here
    (~6e-3 over seeds 6-10). So the generators' and discriminators'
    momentum is held to 5e-2 of scale, CyDA's detector's to 2e-2 (a
    detector gradient a few percent off fails); CyCADA's detector is held
    exactly below.

    CyCADA's JAX tree has no detector (its translation phase never calls
    it, so flax never creates it); the port's detector has a zero
    gradient, so the coupled weight decay and the momentum alone move it,
    exactly as SGD computes that, and the frozen stem and layer1 stay."""
    assert gan_run['gan']
    cycada = gan_run['det_type'] == 'CyCADA'
    check_losses(gan_run, GAN_KEYS | (set() if cycada else
                                      DET_KEYS | {'globle_da_loss'}))
    for tm in gan_run['tmetrics']:
        assert 'skipped_nonfinite' not in tm
        np.testing.assert_allclose(
            tm['loss'], sum(v for k, v in tm.items() if k != 'loss'),
            rtol=1e-6)
    extra = check_state(gan_run, mom_tols=((('gen_', 'disc_'), 5e-2),
                                           ('', 2e-2)))
    trainer, state, start = (gan_run['trainer'], gan_run['state'],
                             gan_run['start'])
    assert state.ema_params is None
    if not cycada:
        assert extra == set()
        return
    assert extra and all(n.startswith(('backbone.', 'rpn_head.',
                                       'bbox_head.')) for n in extra)
    tx_main = trainer.optimizer[0]
    mu, wd = tx_main.spec.momentum, tx_main.spec.weight_decay
    params = dict(trainer.model.named_parameters())
    for n in extra:
        p0 = start[n].double()
        if not tx_main.trainable[n]:
            assert torch.equal(params[n].detach(), start[n]), n
            continue
        m = wd * p0
        p = p0 - tx_main.schedule(0) * m
        m = mu * m + wd * p
        p = p - tx_main.schedule(1) * m
        np.testing.assert_allclose(params[n].detach().double(), p,
                                   rtol=1e-6, atol=1e-12, err_msg=n)
        np.testing.assert_allclose(state.opt_state[0].momentum[n].double(),
                                   m, rtol=1e-6, atol=1e-12, err_msg=n)
