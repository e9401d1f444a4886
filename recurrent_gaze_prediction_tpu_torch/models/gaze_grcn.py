"""gaze_grcn, the paper's model: ConvGRU (GRU-RCN) over C3D maps and the
deconv decoder. The port's counterpart of the JAX package's
`models/gaze_grcn.py`:

    c3d [B,T,1024,7,7] -> 1024->512 projection (+dropout)
      -> ConvGRU(128 units, 3x3, no biases) over T
      -> per-frame decoder (frozen BN -> deconv x3 -> 12->1 head)
      -> logits [B, T, 49, 49]

and `gaze_grcn77`: the same trunk at 7x7 with a per-cell 128->1 linear
head and no upsampling. Inference runs the recurrence through the CUDA
kernel's wrapper (`ops/kernels/convgru.py`); training keeps the
differentiable plain scan.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import ModelConfig
from ..ops import initializers as init
from ..ops.cells import ConvGRU
from ..ops.kernels.convgru import convgru_scan
from ..ops.layers import dropout, linear
from .common import (GazeModel, apply_c3d_projection, apply_decoder,
                     compute_dtype_of, init_c3d_projection, init_decoder)


class _GRCNTrunk(GazeModel):
    """Projection + ConvGRU shared by both heads."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg)
        self.c3d_proj = nn.ParameterDict(init_c3d_projection(
            cfg.dim_feature, cfg.dim_cnn_proj, generator=generator))
        self.cell = nn.ParameterDict(ConvGRU.init(
            cfg.dim_cnn_proj, cfg.rnn_state_size, generator=generator))

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
        scan = ConvGRU.scan if train else convgru_scan
        _, ys = scan(self.cell, xs, h0, compute_dtype=cdt)
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
