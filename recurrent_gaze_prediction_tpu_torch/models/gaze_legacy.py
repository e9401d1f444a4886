"""The legacy prototypes with pupil heads: the port's counterpart of the JAX
package's `models/gaze_legacy.py`, registered as `gaze_pupil_grcn` and
`gaze_pupil_gru2`.

  * gaze_pupil_grcn (reference `model_gru_rcn.py`): the GRU-RCN trunk
    (1024->32 projection, ConvGRU of `rnn_state_size` units, 64 in the
    registry) and ONE joint output projection [7*7*U, 49+1] giving the 7x7
    gaze logits and the pupil scalar together (`model_gru_rcn.py:95-96`).
    Loss = sum_t [ l2(gaze) + 0.01 * l2(pupil) ] / B, with TF's l2_loss =
    0.5*sum(sq) and the division by the batch size ONLY, not B*T
    (`model_gru_rcn.py:135-144`); the gaze targets enter raw. Its
    recurrence takes the route of gaze_grcn's trunk (`convgru_route`): at
    U=64 kernel B1 to predict, B1 and B2 to train, on clusters of 4.
  * gaze_pupil_gru2 (reference `model_2layer_gru.py`): a flat GRU whose
    input at step t is the C3D embedding beside an embedding of the
    PREVIOUS step's ground-truth joint [gaze|pupil] vector, through the
    TIED inverse projection (y_{t-1} - b_out) @ proj_out_W^T
    (`model_2layer_gru.py:50,80-82`), a zero embedding at step 0, and zero
    feedback at inference. Loss = sum_t [ softmax-xent(gaze) + 0.5 *
    l2(pupil) ] / B (`model_2layer_gru.py:90-98`), the gaze targets
    normalized to a probability map.

As in the JAX package (PARITY.md), dropout acts on the output logits and
only in training, where the prototypes apply it always. Under a model
axis `proj_out_W` holds this rank's columns (`linear` gathers its
product); the tied transpose gathers the whole weight first. `batch["pupils"]`
[B, T] is a loss target; the half-batch flip leaves it as it is.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import ModelConfig
from ..ops import initializers as init
from ..ops.cells import FlatGRU
from ..ops.collectives import whole_weight
from ..ops.layers import dropout, linear
from ..ops.normalize import (normalize_probability_map,
                             softmax_cross_entropy_2d)
from .common import (GazeModel, apply_c3d_projection, compute_dtype_of,
                     init_c3d_projection)
from .gaze_grcn import _GRCNTrunk

DIM_PROJ = 32
PUPIL_WEIGHT_GRCN = 0.01   # model_gru_rcn.py:141
PUPIL_WEIGHT_GRU2 = 0.5    # model_2layer_gru.py:95


class PupilGazeModel(GazeModel):
    """A gaze model with a joint [gaze | pupil] output and the prototypes'
    joint losses. `joint(frames, c3d, targets, ...)` returns the joint
    logits [B, T, GH*GW + 1]; `forward` returns the gaze part as maps."""

    pupil_weight = PUPIL_WEIGHT_GRCN
    kind = "grcn"   # grcn | gru2
    reads_frames = False

    def joint(self, frames, c3d: torch.Tensor,
              targets: Optional[torch.Tensor] = None, *, train: bool = False,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        raise NotImplementedError

    def _logit_dropout(self, joint: torch.Tensor, train: bool,
                       generator: Optional[torch.Generator]) -> torch.Tensor:
        """Dropout on the output logits (`model_gru_rcn.py:129`,
        `model_2layer_gru.py:90`), in training only."""
        keep = self.cfg.dropout_keep_prob if train else 1.0
        return dropout(joint, keep, generator, deterministic=not train)

    def forward(self, frames, c3d: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        gh, gw = self.cfg.gazemap_height, self.cfg.gazemap_width
        b, t = c3d.shape[:2]
        joint = self.joint(frames, c3d, None, train=train,
                           generator=generator)
        return joint[..., :gh * gw].reshape(b, t, gh, gw)

    def loss(self, batch: dict, *, train: bool = True,
             generator: Optional[torch.Generator] = None
             ) -> tuple[torch.Tensor, dict]:
        gh, gw = self.cfg.gazemap_height, self.cfg.gazemap_width
        pupils = batch["pupils"].float()
        gazemaps = batch["gazemaps"]
        b, t = gazemaps.shape[:2]
        if self.kind == "grcn":
            # raw (unnormalized) l2 targets, model_gru_rcn.py:132-136
            joint = self.joint(batch.get("frames"), batch["c3d"], None,
                               train=train, generator=generator)
            gaze, pupil = joint[..., :gh * gw], joint[..., -1]
            gaze_loss = 0.5 * (gaze - gazemaps.reshape(b, t, -1)
                               ).square().sum()
        else:
            gaze_gt = normalize_probability_map(gazemaps)
            targets = torch.cat([gaze_gt.reshape(b, t, gh * gw),
                                 pupils[..., None]], dim=-1)
            joint = self.joint(batch.get("frames"), batch["c3d"], targets,
                               train=train, generator=generator)
            gaze, pupil = joint[..., :gh * gw], joint[..., -1]
            gaze_loss = softmax_cross_entropy_2d(
                gaze.reshape(b, t, gh, gw), gaze_gt).sum()
        pupil_loss = 0.5 * (pupil - pupils).square().sum()
        # both prototypes divide by B only (model_gru_rcn.py:135-144,
        # model_2layer_gru.py:98)
        loss = (gaze_loss + self.pupil_weight * pupil_loss) / b
        return loss, {"logits": gaze.reshape(b, t, gh, gw), "pupil": pupil,
                      "gaze_loss": gaze_loss / b,
                      "pupil_loss": pupil_loss / b}


class PupilGRCN(PupilGazeModel, _GRCNTrunk):
    """gaze_pupil_grcn: the GRU-RCN trunk and the joint [7*7*U, 50] head."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg, generator=generator, dim_proj=DIM_PROJ)
        out_dim = cfg.gazemap_height * cfg.gazemap_width + 1
        self.proj_out_W = nn.Parameter(init.uniform_scale(
            (7 * 7 * cfg.rnn_state_size, out_dim), 0.1, generator=generator))
        self.proj_out_b = nn.Parameter(init.zeros((out_dim,)))

    def joint(self, frames, c3d: torch.Tensor,
              targets: Optional[torch.Tensor] = None, *, train: bool = False,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        del frames, targets
        keep = self.cfg.dropout_keep_prob if train else 1.0
        b, t = c3d.shape[:2]
        folded = self._states(c3d, keep=keep, train=train,
                              generator=generator)     # [B*T, 7, 7, U]
        joint = linear(folded.reshape(b * t, -1), self.proj_out_W,
                       self.proj_out_b, compute_dtype=compute_dtype_of(
                           self.cfg))
        return self._logit_dropout(joint, train, generator).reshape(b, t, -1)


class PupilGRU2(PupilGazeModel):
    """gaze_pupil_gru2: the teacher-forced flat GRU and the joint head."""

    pupil_weight = PUPIL_WEIGHT_GRU2
    kind = "gru2"

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg)
        g = generator
        out_dim = cfg.gazemap_height * cfg.gazemap_width + 1
        state = cfg.rnn_state_size
        self.c3d_proj = nn.ParameterDict(init_c3d_projection(
            cfg.dim_feature, DIM_PROJ, generator=g))
        self.cell = nn.ParameterDict(FlatGRU.init(
            7 * 7 * DIM_PROJ + state, state, generator=g))
        # the inverse projection is TIED: proj_out_W^T (model_2layer_gru.py:50)
        self.proj_out_W = nn.Parameter(init.uniform_scale(
            (state, out_dim), 0.1, generator=g))
        self.proj_out_b = nn.Parameter(init.zeros((out_dim,)))

    def joint(self, frames, c3d: torch.Tensor,
              targets: Optional[torch.Tensor] = None, *, train: bool = False,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """targets [B, T, GH*GW + 1]: step t sees targets[t-1] (teacher
        forcing, `model_2layer_gru.py:77-82`); None feeds zeros (inference,
        no ground truth)."""
        del frames
        cdt = compute_dtype_of(self.cfg)
        keep = self.cfg.dropout_keep_prob if train else 1.0
        b, t = c3d.shape[:2]
        state = self.cfg.rnn_state_size
        if targets is None:
            targets = c3d.new_zeros((b, t, self.proj_out_b.shape[0]),
                                    dtype=torch.float32)
        embedded = apply_c3d_projection(self.c3d_proj, c3d, keep_prob=keep,
                                        generator=generator, train=train,
                                        compute_dtype=cdt)
        xs = embedded.reshape(b, t, -1).transpose(0, 1)     # [T, B, D]
        # e_t = (y_{t-1} - b_out) @ proj_out_W^T; step 0 sees zeros
        prev = targets.transpose(0, 1)[:-1]                 # [T-1, B, 50]
        embeds = linear((prev - self.proj_out_b).reshape(
            (t - 1) * b, prev.shape[-1]), whole_weight(self.proj_out_W).t(),
            compute_dtype=cdt)
        embeds = torch.cat([embeds.new_zeros((1, b, state)),
                            embeds.reshape(t - 1, b, state)])
        h0 = FlatGRU.zero_state(b, state, device=c3d.device)
        _, ys = FlatGRU.scan(self.cell, torch.cat([xs, embeds], dim=-1), h0,
                             compute_dtype=cdt)
        logits = linear(ys.reshape(t * b, -1), self.proj_out_W,
                        self.proj_out_b, compute_dtype=cdt)
        logits = self._logit_dropout(logits, train, generator)
        return logits.reshape(t, b, -1).transpose(0, 1)


def build_grcn(cfg: ModelConfig, *,
               generator: Optional[torch.Generator] = None) -> GazeModel:
    return PupilGRCN(cfg, generator=generator)


def build_gru2(cfg: ModelConfig, *,
               generator: Optional[torch.Generator] = None) -> GazeModel:
    return PupilGRU2(cfg, generator=generator)
