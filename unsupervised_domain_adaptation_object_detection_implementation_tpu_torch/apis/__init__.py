from .hooks import ema_update, guard_nonfinite_update
from .inference import (DetectorBundle, inference_detector, init_detector,
                        prepare_batch)
from .train import Trainer, init_trainer
from .train_state import (OptimizerSpec, TrainState, create_train_state,
                          make_lr_schedule, make_train_step)

__all__ = ['DetectorBundle', 'OptimizerSpec', 'TrainState', 'Trainer',
           'create_train_state', 'ema_update', 'guard_nonfinite_update',
           'inference_detector', 'init_detector', 'init_trainer',
           'make_lr_schedule', 'make_train_step', 'prepare_batch']
