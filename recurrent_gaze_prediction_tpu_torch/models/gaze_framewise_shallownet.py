"""gaze_framewise_shallownet, the per-frame saliency baseline: ShallowNet on
every frame. The port's counterpart of the JAX package's
`models/gaze_framewise_shallownet.py` (reference `FramewiseShallowNet`,
`models/gaze_framewise_shallownet.py:75-90`).

The frames [B, T, 98, 98, 3] are folded into one batch, run through
ShallowNet (its dropout off, as inside every gaze model) and reshaped to
[B, T, 49, 49]. The reference's defaults are T=35, batch 5, l2 loss.
Unlike the recurrent models' ShallowNet branch, this ShallowNet IS the
model and trains (`has_shallownet = False`: nothing is frozen), and it is
the model whose forward reads `frames`: the raw-video pipeline's frame
stream (every 5th frame from 15, resized to 98x98) feeds it. It reads no
C3D features, so that pipeline does not run the tower for it
(`reads_c3d = False`), as XLA drops the unused tower from the JAX
package's compiled program.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import ModelConfig
from . import shallownet
from .common import GazeModel, compute_dtype_of


class GazeFramewiseShallowNet(GazeModel):
    reads_frames = True
    reads_c3d = False       # the raw-video pipeline skips the C3D tower
    has_shallownet = False  # trained end to end, not frozen

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg)
        self.shallownet = nn.ParameterDict(
            shallownet.init_params(generator=generator))

    def forward(self, frames: torch.Tensor, c3d, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        del c3d, generator  # no dropout inside the gaze models
        b, t = frames.shape[:2]
        maps = shallownet.apply(
            self.shallownet, frames.reshape(-1, *frames.shape[2:]),
            train=False, compute_dtype=compute_dtype_of(self.cfg))
        return maps.reshape(b, t, 49, 49)


def build(cfg: ModelConfig, *,
          generator: Optional[torch.Generator] = None) -> GazeModel:
    return GazeFramewiseShallowNet(cfg, generator=generator)
