from .hooks import ema_update, guard_nonfinite_update
from .inference import (DetectorBundle, inference_detector, init_detector,
                        prepare_batch)
from .test import evaluate_dataset, results_from_batch, run_inference
from .train import Trainer, init_trainer, train_detector
from .train_state import (OptimizerSpec, TrainState, create_train_state,
                          make_lr_schedule, make_train_step)

__all__ = ['DetectorBundle', 'OptimizerSpec', 'TrainState', 'Trainer',
           'create_train_state', 'ema_update', 'evaluate_dataset',
           'guard_nonfinite_update', 'inference_detector', 'init_detector',
           'init_trainer', 'make_lr_schedule', 'make_train_step',
           'prepare_batch', 'results_from_batch', 'run_inference',
           'train_detector']
