"""SABL Faster R-CNN with `cascade=True` (two bucketing stages, the second
on the first's detached decode) against the JAX package
(`configs/sabl/sabl_cascade_rcnn_r50_fpn_1x.py` with an R18 trunk and 4
classes), through `test_torch_sabl_rcnn.roi_case`, whose tolerances these
are; and its refusal of several ranks, as the cascade family's.
"""

import importlib
import pathlib

import pytest

from .test_torch_cascade import check_losses, check_update
from .test_torch_rpn_detectors import check_predict
from .test_torch_sabl_rcnn import RPN_KEYS, SABL, SEED, STAGE_KEYS, TINY, \
    roi_case
from .torch_port_utils import PORT_PKG

ROOT = pathlib.Path(__file__).resolve().parent.parent
CASCADE = SABL.replace('faster', 'cascade')
KEYS = RPN_KEYS | {f's{i}.{k}' for i in range(2) for k in STAGE_KEYS}

ttrain = importlib.import_module(f'{PORT_PKG}.apis.train')
tconfig = importlib.import_module(f'{PORT_PKG}.utils.config')


@pytest.fixture(scope='module')
def case():
    return roi_case(CASCADE, SEED, TINY, 1000, 512, stages=2)


def test_sabl_cascade_losses_match(case):
    check_losses(case, KEYS)


def test_sabl_cascade_sgd_update_matches(case):
    check_update(case)


def test_sabl_cascade_predict_matches(case):
    check_predict(case)


def test_several_ranks_refuse_the_sabl_cascade(tmp_path):
    """The cascade form has no multi-rank step, as the cascade family has
    none: a multi-rank run raises before the loop makes its work dir; the
    one-stage-of-boxes form trains on several ranks."""
    cfg = tconfig.Config.fromfile(str(ROOT / CASCADE))
    with pytest.raises(NotImplementedError, match='several ranks'):
        ttrain.train_detector(cfg, str(tmp_path / 'wd'), n_devices=2,
                              device='cpu')
    assert not (tmp_path / 'wd').exists()
    ttrain._refuse_unported(tconfig.Config.fromfile(str(ROOT / SABL)),
                            'jax', n_devices=2)
