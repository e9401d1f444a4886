"""gaze_rnn, the flat-GRU gaze model, and its 7x7 variant gaze_rnn77: the
port's counterpart of the JAX package's `models/gaze_rnn.py` (reference
`GazePredictionGRU`, `models/gaze_rnn.py:211-360`):

    c3d -> 1024->32 projection (+dropout) -> flatten 7*7*32
        -> flat GRUCell, state 7*7*32 + 7*7 = 1617 (gaze_rnn.py:245-246)
        -> one [T*B, 1617] x [1617, GH*GW] output product after the scan

gaze_rnn77 is the same network at GH=GW=7, T=35, l2 loss.

The reference also runs ShallowNet on every frame, but the result feeds
nothing (its concat into the GRU input is commented out,
`gaze_rnn.py:330-336`); the JAX package computes it and XLA drops it from
the compiled program. The port keeps its parameters (frozen by default,
`has_shallownet`) and runs the branch only when a caller asks for the
`net` introspection dict (`frm_sal`, and at 7x7 `frm_sal_77`, the 7x7/7
VALID average pool of `gaze_rnn.py:262-269`). So the forward takes B and
T from `c3d` and does not read `frames` (`reads_frames = False`), and the
raw-video pipeline skips the frame resize for it.

The flat GRU is plain PyTorch: no TPU kernel covers it.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import ModelConfig
from ..ops import initializers as init
from ..ops.cells import FlatGRU
from ..ops.layers import avg_pool2d, linear
from . import shallownet
from .common import (GazeModel, apply_c3d_projection, compute_dtype_of,
                     init_c3d_projection)

DIM_CNN_PROJ = 32  # gaze_rnn.py:241


def rnn_state_size() -> int:
    """7*7*32 (the C3D embedding) + 7*7 (the saliency map's slot),
    `gaze_rnn.py:245-246`."""
    return 7 * 7 * DIM_CNN_PROJ + 7 * 7


class GazeRNN(GazeModel):
    reads_frames = False    # the ShallowNet branch feeds nothing
    has_shallownet = True   # its parameters stay frozen by default

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg)
        g = generator
        state = rnn_state_size()
        gh, gw = cfg.gazemap_height, cfg.gazemap_width
        self.shallownet = nn.ParameterDict(shallownet.init_params(
            generator=g))
        self.c3d_proj = nn.ParameterDict(init_c3d_projection(
            cfg.dim_feature, DIM_CNN_PROJ, generator=g))
        self.cell = nn.ParameterDict(FlatGRU.init(
            7 * 7 * DIM_CNN_PROJ, state, generator=g))
        self.proj_out_W = nn.Parameter(init.uniform_scale(
            (state, gh * gw), 0.1, generator=g))
        self.proj_out_b = nn.Parameter(init.zeros((gh * gw,)))

    def forward(self, frames, c3d: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                net: Optional[dict] = None) -> torch.Tensor:
        cdt = compute_dtype_of(self.cfg)
        keep = self.cfg.dropout_keep_prob if train else 1.0
        gh, gw = self.cfg.gazemap_height, self.cfg.gazemap_width
        b, t = c3d.shape[:2]
        if net is not None and frames is not None:
            frm_sal = shallownet.apply(
                self.shallownet, frames.reshape(-1, *frames.shape[2:]),
                train=False, compute_dtype=cdt)
            net["frm_sal"] = frm_sal.reshape(b, t, 49, 49)
            if (gh, gw) == (7, 7):
                net["frm_sal_77"] = avg_pool2d(
                    frm_sal[..., None], 7, 7, "VALID").reshape(b, t, 7, 7)

        embedded = apply_c3d_projection(self.c3d_proj, c3d, keep_prob=keep,
                                        generator=generator, train=train,
                                        compute_dtype=cdt)
        xs = embedded.reshape(b, t, -1).transpose(0, 1)   # [T, B, 7*7*32]
        h0 = FlatGRU.zero_state(b, rnn_state_size(), device=c3d.device)
        _, ys = FlatGRU.scan(self.cell, xs, h0, compute_dtype=cdt)
        out = linear(ys.reshape(t * b, -1), self.proj_out_W,
                     self.proj_out_b, compute_dtype=cdt)
        return out.reshape(t, b, gh, gw).transpose(0, 1)


def build(cfg: ModelConfig, *,
          generator: Optional[torch.Generator] = None) -> GazeModel:
    return GazeRNN(cfg, generator=generator)
