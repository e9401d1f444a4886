"""gaze_grcn, the paper's model: ConvGRU (GRU-RCN) over C3D maps and the
deconv decoder. The port's counterpart of the JAX package's
`models/gaze_grcn.py`:

    c3d [B,T,1024,7,7] -> 1024->512 projection (+dropout)
      -> ConvGRU(128 units, 3x3, no biases) over T
      -> per-frame decoder (frozen BN -> deconv x3 -> 12->1 head)
      -> logits [B, T, 49, 49]

and `gaze_grcn77`: the same trunk at 7x7 with a per-cell 128->1 linear
head and no upsampling. The recurrence runs by the route of its cell
(`ops/kernels/route.py`, decided from the shapes alone): kernel B1 to
predict; to train, the autograd Function `convgru_scan_trainable` (forward
B1, backward B4's phase G, kernel B2 and phase W, `ops/kernels/
convgru_vjp.py`); for a bf16 width too large for B1's shared memory (a
multiple of 128, e.g. U=256) kernel B6 (`ops/kernels/convgru_grid.py`)
both ways; `ConvGRU.scan` for a width (U not a multiple of 16) or a kernel
size (not 3x3) the kernels do not take, on any device. On a CPU tensor the
kernel route runs the kernels' plain versions. The forward records the
route it took in `last_route`.

gaze_grcn does not read `frames`, so the raw-video pipeline skips their
resize for it (`reads_frames`).

Unlike the JAX package, whose train step keeps the differentiable
`lax.scan` (its custom VJP was a fusion barrier for XLA on the TPU), the
port trains through the kernels; `ConvGRU.scan` under autograd stays the
plain version of the whole trainable recurrence, run where
`recurrence_route` answers "scan".
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import ModelConfig
from ..ops import initializers as init
from ..ops.cells import ConvGRU
from ..ops.kernels.route import convgru_route, run_convgru
from ..ops.layers import dropout, linear
from ..train.profiler import span
from .common import (GazeModel, apply_c3d_projection, apply_decoder,
                     compute_dtype_of, init_c3d_projection, init_decoder)


class _GRCNTrunk(GazeModel):
    """Projection + ConvGRU shared by both heads (and by the pupil
    prototype gaze_pupil_grcn, `models/gaze_legacy.py`)."""

    reads_frames = False  # both heads use only the C3D stream
    last_route: Optional[str] = None

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None,
                 dim_proj: Optional[int] = None):
        super().__init__(cfg)
        dim_proj = cfg.dim_cnn_proj if dim_proj is None else dim_proj
        self.c3d_proj = nn.ParameterDict(init_c3d_projection(
            cfg.dim_feature, dim_proj, generator=generator))
        self.cell = nn.ParameterDict(ConvGRU.init(
            dim_proj, cfg.rnn_state_size, generator=generator))

    def recurrence_route(self, train: bool) -> str:
        """The route of this model's cell (`convgru_route`)."""
        return convgru_route(self.cell, (7, 7), compute_dtype_of(self.cfg),
                             train)

    def _states(self, c3d: torch.Tensor, *, keep: float, train: bool,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        """c3d [B,T,1024,7,7] -> hidden states folded to [B*T, 7, 7, U]."""
        cdt = compute_dtype_of(self.cfg)
        units = self.cfg.rnn_state_size
        b, t = c3d.shape[:2]
        embedded = apply_c3d_projection(self.c3d_proj, c3d, keep_prob=keep,
                                        generator=generator, train=train,
                                        compute_dtype=cdt)  # [B,T,7,7,P]
        xs = embedded.transpose(0, 1)                      # [T,B,7,7,P]
        h0 = ConvGRU.zero_state(b, (7, 7), units, device=c3d.device)
        self.last_route = self.recurrence_route(train)
        with span("gaze.recurrence"):
            _, ys = run_convgru(self.cell, xs, h0, compute_dtype=cdt,
                                train=train, route=self.last_route)
        return ys.transpose(0, 1).reshape(b * t, 7, 7, units)


class GazeGRCN(_GRCNTrunk):
    """49x49 maps through the deconv decoder."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg, generator=generator)
        self.decoder = nn.ParameterDict(init_decoder(
            cfg.rnn_state_size, with_batch_norm=True, generator=generator))

    def forward(self, frames, c3d: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        del frames  # gaze_grcn uses only the C3D stream
        keep = self.cfg.dropout_keep_prob if train else 1.0
        b, t = c3d.shape[:2]
        folded = self._states(c3d, keep=keep, train=train,
                              generator=generator)
        maps = apply_decoder(self.decoder, folded, keep_prob=keep,
                             generator=generator, train=train,
                             compute_dtype=compute_dtype_of(self.cfg))
        return maps.reshape(b, t, 49, 49)


class GazeGRCN77(_GRCNTrunk):
    """7x7 logits via a per-cell FC head (`gaze_grcn77.py:183-212`)."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg, generator=generator)
        self.out_W = nn.Parameter(init.uniform_scale(
            (cfg.rnn_state_size, 1), 0.1, generator=generator))
        self.out_b = nn.Parameter(init.uniform_scale(
            (1,), 0.1, generator=generator))

    def forward(self, frames, c3d: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        del frames
        keep = self.cfg.dropout_keep_prob if train else 1.0
        b, t = c3d.shape[:2]
        folded = self._states(c3d, keep=keep, train=train,
                              generator=generator)
        out = linear(folded.reshape(-1, self.cfg.rnn_state_size), self.out_W,
                     self.out_b, compute_dtype=compute_dtype_of(self.cfg))
        out = dropout(out, keep, generator, deterministic=not train)
        return out.reshape(b, t, 7, 7)


def build(cfg: ModelConfig, *,
          generator: Optional[torch.Generator] = None) -> GazeModel:
    if (cfg.gazemap_height, cfg.gazemap_width) == (7, 7):
        return GazeGRCN77(cfg, generator=generator)
    return GazeGRCN(cfg, generator=generator)
