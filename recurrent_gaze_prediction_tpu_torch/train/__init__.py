"""Training: state and optimizer, schedules, the fit loops (feature-fed and
from raw video), checkpoints and the metric writer (the port's counterpart
of the JAX package's `train/`).

The names below load with their module on first use, so that the models
and the input pipeline can import `train.profiler` (spans) without this
package importing them back."""

import importlib

_MODULE_OF = {
    "Checkpointer": "checkpoint", "load_params": "checkpoint",
    "restore_shallownet": "checkpoint", "save_params": "checkpoint",
    "FusedTrainState": "fused", "fit_fused": "fused",
    "fit": "loop",
    "Optimizer": "state", "TrainState": "state", "build_optimizer": "state",
    "build_schedule": "state", "create_train_state": "state",
    "flip_half_batch": "state", "make_eval_step": "state",
    "make_predict_fn": "state", "make_train_step": "state",
}

__all__ = ["schedules", *_MODULE_OF]


def __getattr__(name: str):
    if name in _MODULE_OF:
        value = getattr(importlib.import_module(
            f".{_MODULE_OF[name]}", __name__), name)
    else:
        try:
            value = importlib.import_module(f".{name}", __name__)
        except ModuleNotFoundError as exc:
            if exc.name != f"{__name__}.{name}":
                raise
            raise AttributeError(
                f"module {__name__!r} has no attribute {name!r}") from None
    globals()[name] = value
    return value
