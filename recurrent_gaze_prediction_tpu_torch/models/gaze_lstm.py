"""gaze_lstm, the peephole ConvLSTM variant of the paper's model. The port's
counterpart of the JAX package's `models/gaze_lstm.py`:

    c3d [B,T,1024,7,7] -> 1024->512 projection (+dropout)
      -> peephole ConvLSTM(128 units, 3x3, no biases, (c, h) state) over T
      -> per-frame decoder (frozen BN -> deconv x3 -> 12->1 head)
      -> logits [B, T, 49, 49]

The projection and decoder are gaze_grcn's (`models/common.py`). The
recurrence runs by the route of its cell (`ops/kernels/route.py`, decided
from the shapes alone): inference through kernel B3's wrapper
(`ops/kernels/convlstm.py`), or `ConvLSTM.scan` at a width B3 does not
take. Training runs `ConvLSTM.scan` under autograd, which is the JAX
package's own train path: it has no backward kernel for the ConvLSTM, so
the port adds none. On a CPU tensor inference uses the kernel's plain
version. The forward records the route it took in `last_route`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import ModelConfig
from ..ops.cells import ConvLSTM
from ..ops.kernels.route import convlstm_route, run_convlstm
from ..train.profiler import span
from .common import (GazeModel, apply_c3d_projection, apply_decoder,
                     compute_dtype_of, init_c3d_projection, init_decoder)


class GazeLSTM(GazeModel):
    """49x49 maps from the ConvLSTM's hidden states through the deconv
    decoder."""

    reads_frames = False  # it uses only the C3D stream
    last_route: Optional[str] = None

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg)
        self.c3d_proj = nn.ParameterDict(init_c3d_projection(
            cfg.dim_feature, cfg.dim_cnn_proj, generator=generator))
        self.cell = nn.ParameterDict(ConvLSTM.init(
            cfg.dim_cnn_proj, cfg.rnn_state_size, spatial=(7, 7),
            generator=generator))
        self.decoder = nn.ParameterDict(init_decoder(
            cfg.rnn_state_size, with_batch_norm=True, generator=generator))

    def recurrence_route(self, train: bool) -> str:
        """The route of this model's cell (`convlstm_route`): "kernel" to
        predict at a width B3 takes, else "scan"."""
        return convlstm_route(self.cfg.rnn_state_size, (7, 7),
                              compute_dtype_of(self.cfg), train)

    def forward(self, frames, c3d: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        del frames  # gaze_lstm uses only the C3D stream
        cdt = compute_dtype_of(self.cfg)
        keep = self.cfg.dropout_keep_prob if train else 1.0
        units = self.cfg.rnn_state_size
        b, t = c3d.shape[:2]
        embedded = apply_c3d_projection(self.c3d_proj, c3d, keep_prob=keep,
                                        generator=generator, train=train,
                                        compute_dtype=cdt)  # [B,T,7,7,P]
        xs = embedded.transpose(0, 1)                      # [T,B,7,7,P]
        carry0 = ConvLSTM.zero_state(b, (7, 7), units, device=c3d.device)
        self.last_route = self.recurrence_route(train)
        with span("gaze.recurrence"):
            _, ys = run_convlstm(self.cell, xs, carry0, compute_dtype=cdt,
                                 route=self.last_route)
        folded = ys.transpose(0, 1).reshape(b * t, 7, 7, units)
        maps = apply_decoder(self.decoder, folded, keep_prob=keep,
                             generator=generator, train=train,
                             compute_dtype=cdt)
        return maps.reshape(b, t, 49, 49)


def build(cfg: ModelConfig, *,
          generator: Optional[torch.Generator] = None) -> GazeModel:
    return GazeLSTM(cfg, generator=generator)
