"""Training: state and optimizer, schedules, the fit loops (feature-fed and
from raw video), checkpoints and the metric writer (the port's counterpart
of the JAX package's `train/`)."""

from . import schedules
from .checkpoint import (Checkpointer, load_params, restore_shallownet,
                         save_params)
from .fused import FusedTrainState, fit_fused
from .loop import fit
from .state import (Optimizer, TrainState, build_optimizer, build_schedule,
                    create_train_state, flip_half_batch, make_eval_step,
                    make_predict_fn, make_train_step)

__all__ = [
    "schedules",
    "TrainState",
    "Optimizer",
    "create_train_state",
    "build_optimizer",
    "build_schedule",
    "flip_half_batch",
    "make_train_step",
    "make_eval_step",
    "make_predict_fn",
    "fit",
    "FusedTrainState",
    "fit_fused",
    "Checkpointer",
    "save_params",
    "load_params",
    "restore_shallownet",
]
