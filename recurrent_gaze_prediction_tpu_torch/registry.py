"""Model registry: string name -> model builder + per-model config defaults.

The port's counterpart of the JAX package's `registry.py`, holding the
families ported so far (`gaze_grcn`, `gaze_grcn77`) with the same defaults
and precedence rules. Any other name raises KeyError.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .config import ModelConfig
from .models import gaze_grcn
from .utils import resolve_device

_REGISTRY: dict[str, tuple[Callable, dict]] = {
    "gaze_grcn": (gaze_grcn.build, dict(
        gazemap_height=49, gazemap_width=49, n_lstm_steps=42, batch_size=7,
        dim_cnn_proj=512, rnn_state_size=128, loss_type="xentropy")),
    "gaze_grcn77": (gaze_grcn.build, dict(
        gazemap_height=7, gazemap_width=7, n_lstm_steps=35, batch_size=7,
        dim_cnn_proj=512, rnn_state_size=128, loss_type="xentropy")),
}


def available_models() -> list[str]:
    return sorted(_REGISTRY)


def _entry(name: str) -> tuple[Callable, dict]:
    if name not in _REGISTRY:
        raise KeyError(
            f"model family '{name}' is not yet ported to the PyTorch "
            f"package (ported: {available_models()}; the rest are queued "
            f"in ROADMAP.md queue A)")
    return _REGISTRY[name]


def create_model(name: str, cfg: Optional[ModelConfig] = None, *,
                 device=None, generator: Optional[torch.Generator] = None,
                 **overrides):
    """Build a model on `device` (None = the card; raises without CUDA).

    Precedence: explicit kwargs > cfg fields the user assigned after
    construction (`ModelConfig.explicit_fields`, so setting a field to
    its dataclass default on purpose still wins) > cfg fields that differ
    from the dataclass default > per-model defaults. Weights are drawn on
    the CPU from `generator` (seed 0 when None), then moved.
    """
    _, defaults = _entry(name)
    dev = resolve_device(device)

    base = cfg if cfg is not None else ModelConfig()
    explicit = base.explicit_fields()
    merged = dataclasses.replace(base)
    field_defaults = ModelConfig()
    for key, value in defaults.items():
        if key in explicit:
            continue
        if getattr(merged, key) == getattr(field_defaults, key):
            setattr(merged, key, value)
    for key, value in overrides.items():
        setattr(merged, key, value)
    merged.name = name
    return build_model(merged, device=dev, generator=generator)


def build_model(cfg: ModelConfig, *, device=None,
                generator: Optional[torch.Generator] = None):
    """Build `cfg.name` from `cfg` exactly as given (no per-model
    defaults), on `device` (None = the card)."""
    builder, _ = _entry(cfg.name)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = builder(cfg, generator=generator)
    return model.to(device=dev, dtype=getattr(torch, cfg.param_dtype))
