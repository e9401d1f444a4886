"""Model registry: string name -> model builder + per-model config defaults.

The port's counterpart of the JAX package's `registry.py`: the same ten
families with the same defaults and precedence rules. Any other name
raises KeyError.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .config import ModelConfig
from .models import (gaze_c3d_conv, gaze_framewise_shallownet, gaze_grcn,
                     gaze_grcn_cascade, gaze_legacy, gaze_lstm, gaze_rnn)
from .utils import resolve_device

_REGISTRY: dict[str, tuple[Callable, dict]] = {
    "gaze_rnn": (gaze_rnn.build, dict(
        gazemap_height=49, gazemap_width=49, n_lstm_steps=42, batch_size=7,
        dim_cnn_proj=32, loss_type="xentropy")),
    "gaze_rnn77": (gaze_rnn.build, dict(
        gazemap_height=7, gazemap_width=7, n_lstm_steps=35, batch_size=7,
        dim_cnn_proj=32, loss_type="l2")),
    "gaze_grcn": (gaze_grcn.build, dict(
        gazemap_height=49, gazemap_width=49, n_lstm_steps=42, batch_size=7,
        dim_cnn_proj=512, rnn_state_size=128, loss_type="xentropy")),
    "gaze_grcn77": (gaze_grcn.build, dict(
        gazemap_height=7, gazemap_width=7, n_lstm_steps=35, batch_size=7,
        dim_cnn_proj=512, rnn_state_size=128, loss_type="xentropy")),
    "gaze_lstm": (gaze_lstm.build, dict(
        gazemap_height=49, gazemap_width=49, n_lstm_steps=42, batch_size=7,
        dim_cnn_proj=512, rnn_state_size=128, loss_type="xentropy")),
    "gaze_grcn_cascade": (gaze_grcn_cascade.build, dict(
        gazemap_height=49, gazemap_width=49, n_lstm_steps=42, batch_size=7,
        dim_cnn_proj=512, loss_type="l2")),
    "gaze_c3d_conv": (gaze_c3d_conv.build, dict(
        gazemap_height=49, gazemap_width=49, n_lstm_steps=42, batch_size=7,
        dim_cnn_proj=512, loss_type="xentropy")),
    "gaze_framewise_shallownet": (gaze_framewise_shallownet.build, dict(
        gazemap_height=49, gazemap_width=49, n_lstm_steps=35, batch_size=5,
        loss_type="l2")),
    # the legacy prototypes with pupil heads (model_gru_rcn.py,
    # model_2layer_gru.py); gaze_pupil_grcn's gaze loss is l2 on the raw
    # joint logits (model_gru_rcn.py:135-136), so it predicts raw maps
    "gaze_pupil_grcn": (gaze_legacy.build_grcn, dict(
        gazemap_height=7, gazemap_width=7, n_lstm_steps=35, batch_size=7,
        dim_cnn_proj=32, rnn_state_size=64, loss_type="l2")),
    "gaze_pupil_gru2": (gaze_legacy.build_gru2, dict(
        gazemap_height=7, gazemap_width=7, n_lstm_steps=35, batch_size=7,
        dim_cnn_proj=32, rnn_state_size=128, loss_type="xentropy")),
}


def available_models() -> list[str]:
    return sorted(_REGISTRY)


def model_defaults(name: str) -> dict:
    return dict(_entry(name)[1])


def _entry(name: str) -> tuple[Callable, dict]:
    if name not in _REGISTRY:
        raise KeyError(
            f"Unknown model '{name}'. Available: {available_models()}")
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
