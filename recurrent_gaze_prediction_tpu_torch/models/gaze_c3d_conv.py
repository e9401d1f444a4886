"""gaze_c3d_conv, the non-recurrent ablation: the C3D projection straight
into the deconv decoder, without a cell and without batch norm. The
port's counterpart of the JAX package's `models/gaze_c3d_conv.py`
(reference `GazePredictionConv`, `models/gaze_c3d_conv.py:141-217`).

Every frame is decoded on its own, so the whole model is one pass over
the B*T folded frames: the projection (dropout in training), then the
decoder (`apply_decoder`: stagewise below 32 frames, else composed into
one matrix, which `decoder_matrix` builds without the BN fold when the
decoder has no BN), dropout on its output.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import ModelConfig
from .common import (GazeModel, apply_c3d_projection, apply_decoder,
                     compute_dtype_of, init_c3d_projection, init_decoder)


class GazeC3DConv(GazeModel):
    reads_frames = False  # only the C3D stream

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg)
        self.c3d_proj = nn.ParameterDict(init_c3d_projection(
            cfg.dim_feature, cfg.dim_cnn_proj, generator=generator))
        # decoder input = dim_cnn_proj (512), no BN (gaze_c3d_conv.py:153-179)
        self.decoder = nn.ParameterDict(init_decoder(
            cfg.dim_cnn_proj, with_batch_norm=False, generator=generator))

    def forward(self, frames, c3d: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        del frames
        cdt = compute_dtype_of(self.cfg)
        keep = self.cfg.dropout_keep_prob if train else 1.0
        b, t = c3d.shape[:2]
        embedded = apply_c3d_projection(self.c3d_proj, c3d, keep_prob=keep,
                                        generator=generator, train=train,
                                        compute_dtype=cdt)
        folded = embedded.reshape(b * t, 7, 7, self.cfg.dim_cnn_proj)
        maps = apply_decoder(self.decoder, folded, keep_prob=keep,
                             generator=generator, train=train,
                             compute_dtype=cdt)
        return maps.reshape(b, t, 49, 49)


def build(cfg: ModelConfig, *,
          generator: Optional[torch.Generator] = None) -> GazeModel:
    return GazeC3DConv(cfg, generator=generator)
