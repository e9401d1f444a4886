"""gaze_grcn_cascade, the two-level coarse-to-fine ConvGRU cascade: the
port's counterpart of the JAX package's `models/gaze_grcn_cascade.py`
(reference `GazePredictionGRCN`, `models/gaze_grcn_cascade.py:188-481`):

    c3d -> 1024->512 projection (no dropout)
        -> bottom ConvGRU (256 units, 3x3) at 7x7
        -> one deconv 11x11 stride 7 SAME over all T*B steps -> [49,49,64]
        -> top ConvGRU (3 units, 5x5) at 49x49
        -> per-frame head: fc 4802 + relu + dropout + maxout
                          -> fc 4802 + relu + maxout -> [49,49]

Each cell runs by its own route (`ops/kernels/route.py`, decided from the
shapes alone). In bf16 the bottom cell takes kernel B6
(`ops/kernels/convgru_grid.py`: its whole sequence in one launch forward,
the backward's recursion in one more, then phase W's weight products) and
the top cell kernel B5 (`ops/kernels/convgru_small.py`: one launch
forward and one backward); in f32 both run their own `ConvGRU.scan`, as
in the JAX package. The forward records the bottom cell's route in
`last_route` (`recurrence_route`) and the top cell's in `top_route`. With
`cfg.remat_cells` in training, each step of a plain scan is checkpointed
(`torch.utils.checkpoint`): on the scan route the 49x49 top cell's per-step
gates are 49x the bottom cell's, and autograd would otherwise keep all of
them. The kernels keep no per-step graph (B5 recomputes its gates from ys,
B6 stores its gates from the forward), so remat has no use on their route.
On a CPU tensor their wrappers run their plain versions.

The ShallowNet branch feeds nothing in the reference (its concat is
commented out, `gaze_grcn_cascade.py:370-377`); its parameters are kept
for parity (`has_shallownet`, frozen by default) and it runs only for a
caller's `net` introspection dict. The top cell takes the 64 upsampled
channels where the reference declares 65 (a latent shape bug there,
`gaze_grcn_cascade.py:17-20`), as in the JAX package.

Spans (`train.profiler`): `gaze.projection`, `gaze.recurrence` (the
bottom cell), `gaze.upsample`, `gaze.top_recurrence`, `gaze.decoder` (the
maxout head); each plain scan counts its steps in `recurrence.plain_steps`
(on the card B5 and B6 count none), B6's forward its steps in
`recurrence.kernel_steps`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import ModelConfig
from ..ops import initializers as init
from ..ops.cells import ConvGRU
from ..ops.kernels.route import convgru_route, run_convgru
from ..ops.layers import conv2d_transpose, dropout, linear, maxout2
from ..train.profiler import span
from . import shallownet
from .common import (GazeModel, apply_c3d_projection, compute_dtype_of,
                     init_c3d_projection)

BOTTOM_UNITS = 256       # gaze_grcn_cascade.py:229
UP_CHANNELS = 64         # gaze_grcn_cascade.py:318
TOP_UNITS = 3            # gaze_grcn_cascade.py:346
TOP_KERNEL = (5, 5)
FC_WIDTH = 4802


class GazeGRCNCascade(GazeModel):
    reads_frames = False    # the ShallowNet branch feeds nothing
    has_shallownet = True
    last_route: Optional[str] = None
    top_route: Optional[str] = None

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg)
        g = generator
        self.shallownet = nn.ParameterDict(shallownet.init_params(
            generator=g))
        self.c3d_proj = nn.ParameterDict(init_c3d_projection(
            cfg.dim_feature, cfg.dim_cnn_proj, generator=g))
        self.bottom_cell = nn.ParameterDict(ConvGRU.init(
            cfg.dim_cnn_proj, BOTTOM_UNITS, generator=g))
        self.up_w = nn.Parameter(init.xavier_uniform(
            (11, 11, BOTTOM_UNITS, UP_CHANNELS), generator=g))
        self.top_cell = nn.ParameterDict(ConvGRU.init(
            UP_CHANNELS, TOP_UNITS, kernel=TOP_KERNEL, generator=g))
        self.fc1_w = nn.Parameter(init.xavier_uniform(
            (49 * 49 * TOP_UNITS, FC_WIDTH), generator=g))
        self.fc1_b = nn.Parameter(init.zeros((FC_WIDTH,)))
        self.fc2_w = nn.Parameter(init.xavier_uniform(
            (FC_WIDTH // 2, FC_WIDTH), generator=g))
        self.fc2_b = nn.Parameter(init.zeros((FC_WIDTH,)))

    def recurrence_route(self, train: bool) -> str:
        """The bottom cell's route (`convgru_route`): "kernel" (B6) in
        bf16, "scan" in f32."""
        return convgru_route(self.bottom_cell, (7, 7),
                             compute_dtype_of(self.cfg), train)

    def forward(self, frames, c3d: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                net: Optional[dict] = None) -> torch.Tensor:
        cdt = compute_dtype_of(self.cfg)
        keep = self.cfg.dropout_keep_prob if train else 1.0
        remat = self.cfg.remat_cells and train
        b, t = c3d.shape[:2]
        if net is not None and frames is not None:
            net["frm_sal"] = shallownet.apply(
                self.shallownet, frames.reshape(-1, *frames.shape[2:]),
                train=False, compute_dtype=cdt).reshape(b, t, 49, 49)
        self.last_route = self.recurrence_route(train)
        self.top_route = convgru_route(self.top_cell, (49, 49), cdt, train)

        embedded = apply_c3d_projection(self.c3d_proj, c3d, keep_prob=1.0,
                                        generator=None, train=False,
                                        compute_dtype=cdt)
        # bottom recurrence at 7x7
        with span("gaze.recurrence"):
            h0 = ConvGRU.zero_state(b, (7, 7), BOTTOM_UNITS,
                                    device=c3d.device)
            _, ys = run_convgru(self.bottom_cell, embedded.transpose(0, 1),
                                h0, compute_dtype=cdt, train=train,
                                route=self.last_route, remat=remat)
        # upsample every step at once: [T*B,7,7,256] -> [T*B,49,49,64], in
        # the compute dtype the top cell's input conv rounds it to anyway
        with span("gaze.upsample"):
            up = conv2d_transpose(ys.reshape(t * b, 7, 7, BOTTOM_UNITS),
                                  self.up_w, stride=7, padding="SAME",
                                  compute_dtype=cdt, out_dtype=cdt)
        # top recurrence at 49x49
        with span("gaze.top_recurrence"):
            g0 = ConvGRU.zero_state(b, (49, 49), TOP_UNITS,
                                    device=c3d.device)
            _, gs = run_convgru(self.top_cell,
                                up.reshape(t, b, 49, 49, UP_CHANNELS), g0,
                                compute_dtype=cdt, train=train,
                                route=self.top_route, remat=remat)
        # per-frame maxout head over T*B
        with span("gaze.decoder"):
            x = torch.relu(linear(gs.reshape(t * b, -1), self.fc1_w,
                                  self.fc1_b, compute_dtype=cdt))
            x = maxout2(dropout(x, keep, generator, deterministic=not train))
            x = maxout2(torch.relu(linear(x, self.fc2_w, self.fc2_b,
                                          compute_dtype=cdt)))
        return x.reshape(t, b, 49, 49).transpose(0, 1)


def build(cfg: ModelConfig, *,
          generator: Optional[torch.Generator] = None) -> GazeModel:
    return GazeGRCNCascade(cfg, generator=generator)
