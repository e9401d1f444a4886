"""Streaming (chunked) inference with carried recurrent state: the port's
counterpart of the JAX package's `models/streaming.py`.

The reference processes long videos as independent 42-frame windows,
restarting the recurrence from zero for every chunk. These steps carry the
recurrent state from chunk to chunk instead, so a video of any length
streams through fixed-size chunks with full temporal context:

  * `grcn_stream_step` carries gaze_grcn's h through kernel B1
    (`convgru_scan` returns the final h);
  * `lstm_stream_step` carries gaze_lstm's (c, h) through kernel B3
    (`convlstm_scan` returns the final c and h; the JAX package's LSTM step
    runs the plain scan, because its kernel drops c).

Each step takes a model and returns (new state, raw per-frame logits
[B, Tc, 49, 49]), as the JAX steps do. The state stays f32 in both
directions: it goes back and forth every chunk, and rounding it would
accumulate error along a long video. Each step runs its cell by the
model's `recurrence_route` (decided in `ops/kernels/route.py`): a width the
kernel does not take runs the cell's own scan. On CPU tensors the steps
run the kernels' plain versions.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..ops.cells import ConvGRU, ConvLSTM
from ..ops.kernels.route import run_convgru, run_convlstm
from ..utils import resolve_device
from .common import (GazeModel, apply_c3d_projection, apply_decoder,
                     compute_dtype_of)
from .gaze_grcn import GazeGRCN
from .gaze_lstm import GazeLSTM


def _embed(model: GazeModel, c3d_chunk: torch.Tensor) -> torch.Tensor:
    """[B,Tc,1024,7,7] -> the time-major projection [Tc,B,7,7,P]."""
    return apply_c3d_projection(
        model.c3d_proj, c3d_chunk, keep_prob=1.0, generator=None,
        train=False, compute_dtype=compute_dtype_of(model.cfg)).transpose(0, 1)


def _decode(model: GazeModel, ys: torch.Tensor) -> torch.Tensor:
    """Hidden states [Tc,B,7,7,U] -> logits [B,Tc,49,49]."""
    tc, b = ys.shape[:2]
    folded = ys.transpose(0, 1).reshape(b * tc, 7, 7, ys.shape[-1])
    maps = apply_decoder(model.decoder, folded, keep_prob=1.0,
                         generator=None, train=False,
                         compute_dtype=compute_dtype_of(model.cfg))
    return maps.reshape(b, tc, 49, 49)


def _require(model: GazeModel, cls: type, step: str) -> None:
    if not isinstance(model, cls):
        raise ValueError(f"{step} streams {cls.__name__} models; got "
                         f"{type(model).__name__} ({model.cfg.name})")


def init_stream_state(batch: int, cfg: ModelConfig, *,
                      device=None) -> torch.Tensor:
    """gaze_grcn's zero state [B,7,7,U] f32 on `device` (None = the
    card)."""
    return ConvGRU.zero_state(batch, (7, 7), cfg.rnn_state_size,
                              device=resolve_device(device))


@torch.inference_mode()
def grcn_stream_step(model: GazeModel, state: torch.Tensor,
                     c3d_chunk: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk of gaze_grcn: ([B,7,7,U] state, [B,Tc,1024,7,7]) ->
    (new state, [B,Tc,49,49] logits), the recurrence through kernel B1."""
    _require(model, GazeGRCN, "grcn_stream_step")
    final_h, ys = run_convgru(model.cell, _embed(model, c3d_chunk),
                              state.float(),
                              compute_dtype=compute_dtype_of(model.cfg),
                              train=False,
                              route=model.recurrence_route(train=False))
    return final_h, _decode(model, ys)


def init_lstm_stream_state(batch: int, cfg: ModelConfig, *, device=None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """gaze_lstm's zero state (c, h), each [B,7,7,U] f32 on `device` (None
    = the card)."""
    return ConvLSTM.zero_state(batch, (7, 7), cfg.rnn_state_size,
                               device=resolve_device(device))


@torch.inference_mode()
def lstm_stream_step(model: GazeModel,
                     state: tuple[torch.Tensor, torch.Tensor],
                     c3d_chunk: torch.Tensor):
    """One chunk of gaze_lstm with the carried (c, h) cell state ->
    ((c, h), [B,Tc,49,49] logits), the recurrence through kernel B3."""
    _require(model, GazeLSTM, "lstm_stream_step")
    c, h = state
    carry, ys = run_convlstm(model.cell, _embed(model, c3d_chunk),
                             (c.float(), h.float()),
                             compute_dtype=compute_dtype_of(model.cfg),
                             route=model.recurrence_route(train=False))
    return carry, _decode(model, ys)


def stream_video(model: GazeModel, c3d_features, chunk_len: int = 42,
                 state: Optional[torch.Tensor] = None) -> Iterator:
    """Iterate (state-carrying) gaze_grcn over a long feature stream
    [T, 1024, 7, 7]; yields [Tc, 49, 49] numpy logit chunks. The tail
    chunk is zero-padded to the chunk length, as the JAX package pads it to
    keep its jitted shape, and trimmed before it is yielded."""
    dev = next(model.parameters()).device
    if state is None:
        state = init_stream_state(1, model.cfg, device=dev)
    t_total = len(c3d_features)
    for start in range(0, t_total, chunk_len):
        chunk = np.asarray(c3d_features[start:start + chunk_len],
                           np.float32)
        valid = len(chunk)
        if valid < chunk_len:
            pad = np.zeros((chunk_len - valid,) + chunk.shape[1:],
                           chunk.dtype)
            chunk = np.concatenate([chunk, pad])
        state, maps = grcn_stream_step(model, state,
                                       torch.from_numpy(chunk[None]).to(dev))
        yield maps[0, :valid].cpu().numpy()
