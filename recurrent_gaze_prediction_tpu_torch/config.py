"""Typed configuration tree of the PyTorch/CUDA port.

The port's own copy of `recurrent_gaze_prediction_tpu/config.py`: the same
dataclasses with the same fields, so a bundle manifest written by either
package (`model` = `dataclasses.asdict(ModelConfig)`) constructs a
`ModelConfig` here. One dataclass hierarchy that round-trips through JSON
and accepts dotted-path CLI overrides.

Defaults mirror the reference:
  * max_steps=100000, steps_per_checkpoint=1000, steps_per_validation=100,
    steps_per_evaluation=2000, steps_per_logprint=5 (`models/base.py:22-43`)
  * learning_rate_decay=0.80, adam, initial lr 0.003, max_grad_norm=10
    (`models/base.py:45-49`)
  * GRU family: n_lstm_steps=42, dim_feature=1024, loss_type='xentropy',
    use_flip_batch=True (`models/gaze_rnn.py:44-61`)
  * image 98x98, gazemap 49x49 (or 7x7 for *77 models)
    (`models/gaze_rnn.py:34-40`, `models/gaze_grcn77.py:39-43`)
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class TrainSchedule:
    """Training-loop cadence (reference `models/base.py:22-43`)."""

    max_steps: int = 100000
    steps_per_checkpoint: int = 1000
    steps_per_validation: int = 100
    steps_per_evaluation: int = 2000
    steps_per_logprint: int = 5


@dataclass
class OptimizerConfig:
    """Optimizer + LR schedule (reference `models/base.py:45-49,262-308`,
    exp-decay staircase 0.8/500 from `models/gaze_rnn.py:436-444`)."""

    method: str = "adam"  # adam | rmsprop | sgd (momentum 0.9)
    initial_learning_rate: float = 0.003
    learning_rate_decay: float = 0.80
    decay_steps: int = 500
    staircase: bool = True
    use_decay_schedule: bool = True  # False -> constant LR variable
    max_grad_norm: float = 10.0
    # gradient accumulation: split each batch into this many microbatches
    # under one optimizer update (numerically the full-batch step; memory
    # lever for global batches beyond HBM). Batch size must divide evenly.
    accum_steps: int = 1
    # Reference trains the ShallowNet subtree with lr=0 ("DO NOT LEARN",
    # `models/gaze_rnn.py:459`); we freeze that param group.
    freeze_shallownet: bool = True


@dataclass
class ModelConfig:
    """Shared model geometry and loss selection.

    Assignments after construction are tracked in `explicit_fields()` so
    `registry.create_model` can tell "user set batch_size to the dataclass
    default on purpose" apart from "never touched" and not clobber it with
    the per-model default.
    """

    name: str = "gaze_grcn"
    image_height: int = 98
    image_width: int = 98
    gazemap_height: int = 49
    gazemap_width: int = 49
    n_lstm_steps: int = 42         # T; sequence length per training window
    batch_size: int = 7
    dim_feature: int = 1024        # C3D conv5b channels (512 x 2 folded)
    dim_cnn_proj: int = 512        # C3D 1024 -> proj (32 for flat gaze_rnn)
    rnn_state_size: int = 128      # ConvGRU/ConvLSTM channels
    loss_type: str = "xentropy"    # l2 | xentropy | kld
    dropout_keep_prob: float = 0.5
    use_flip_batch: bool = True
    # numerics
    compute_dtype: str = "bfloat16"   # conv/matmul compute dtype
    param_dtype: str = "float32"
    # Read from configs and manifests written by the JAX package, and has
    # no effect here: on a CUDA tensor the models run the hand-written
    # recurrence kernels at every shape they take and the cell's own scan
    # at the others (`ops/kernels/route.py`, read through each model's
    # `recurrence_route`); a CPU tensor runs the kernels' plain versions.
    use_pallas: bool = False
    # rematerialize each recurrence step in the backward pass: the
    # cascade's two cells run `ConvGRU.scan(remat=True)` in training. The
    # kernels' trainable recurrence (gaze_grcn, gaze_pupil_grcn) saves only
    # the hidden states and recomputes the gates in its backward either way
    remat_cells: bool = True

    def __post_init__(self):
        # created AFTER dataclass __init__'s setattr calls, so construction
        # itself marks nothing explicit; only later assignments are tracked
        object.__setattr__(self, "_explicit", set())

    def __setattr__(self, key, value):
        tracked = getattr(self, "_explicit", None)
        if tracked is not None and not key.startswith("_"):
            tracked.add(key)
        object.__setattr__(self, key, value)

    def explicit_fields(self) -> set:
        """Field names assigned after construction (e.g. via CLI overrides)."""
        return set(getattr(self, "_explicit", ()))


@dataclass
class ShardingConfig:
    """Rank-mesh layout: batch ("data") as the primary parallel axis and
    an optional "model" axis (`parallel.mesh_from_config`)."""

    data_parallel: int = -1   # -1 = all devices
    model_parallel: int = 1


@dataclass
class ExperimentConfig:
    """Top-level config: everything needed to reproduce a run."""

    model: ModelConfig = field(default_factory=ModelConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    schedule: TrainSchedule = field(default_factory=TrainSchedule)
    sharding: ShardingConfig = field(default_factory=ShardingConfig)
    train_dir: Optional[str] = None
    train_tag: str = ""
    dataset: str = "synthetic"     # crc | hollywood2 | crcxh2 | salicon | synthetic
    seed: int = 0

    # ------------------------------------------------------------------ io

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def dump(self, fp) -> None:
        """JSON dump (reference `models/base.py:60-72`)."""
        if isinstance(fp, str):
            with open(fp, "w") as f:
                self.dump(f)
            return
        json.dump(self.to_dict(), fp, sort_keys=True, indent=4,
                  separators=(",", ": "))
        fp.write("\n")
        fp.flush()

    @staticmethod
    def load(fp) -> "ExperimentConfig":
        """JSON load with attribute merge (reference `models/base.py:74-85`)."""
        if isinstance(fp, str):
            with open(fp, "r") as f:
                return ExperimentConfig.load(f)
        raw = json.load(fp)
        return ExperimentConfig.from_dict(raw)

    @staticmethod
    def from_dict(raw: dict) -> "ExperimentConfig":
        cfg = ExperimentConfig()
        for section_name, section_cls in (
            ("model", ModelConfig),
            ("optimizer", OptimizerConfig),
            ("schedule", TrainSchedule),
            ("sharding", ShardingConfig),
        ):
            section_raw = raw.get(section_name, {})
            section = section_cls()
            for key, value in section_raw.items():
                if hasattr(section, key):
                    setattr(section, key, value)
            setattr(cfg, section_name, section)
        for key in ("train_dir", "train_tag", "dataset", "seed"):
            if key in raw:
                setattr(cfg, key, raw[key])
        return cfg

    # ------------------------------------------------------- cli overrides

    def apply_overrides(self, overrides: dict[str, Any]) -> "ExperimentConfig":
        """Apply dotted-path overrides, e.g. {"model.batch_size": 28,
        "optimizer.initial_learning_rate": 1e-4}. CLI wins over defaults,
        mirroring `models/train_gaze.py:84-101` precedence."""
        for path, value in overrides.items():
            if value is None:
                continue
            obj = self
            *parents, leaf = path.split(".")
            for p in parents:
                obj = getattr(obj, p)
            if not hasattr(obj, leaf):
                raise AttributeError(f"Unknown config key: {path}")
            current = getattr(obj, leaf)
            if current is not None and not isinstance(current, type(value)):
                value = _coerce(value, type(current), path)
            setattr(obj, leaf, value)
        return self


def _coerce(value: Any, target: type, path: str) -> Any:
    """Coerce a CLI-string override to the config field's type.

    `bool("False")` is True, so bools get a real parser instead of the
    constructor; everything else keeps `type(current)(value)` semantics.
    """
    if target is bool:
        if isinstance(value, str):
            low = value.strip().lower()
            if low in ("true", "1", "yes", "on"):
                return True
            if low in ("false", "0", "no", "off"):
                return False
            raise ValueError(
                f"Cannot parse {value!r} as bool for config key {path}")
        return bool(value)
    return target(value)
