"""Window (temporal) sharding of one long video: the port's counterpart of
the JAX package's `parallel/temporal.py`.

Batch parallelism needs many clips to fill the ranks; one long video
leaves them idle. But almost all of the fused program's work is in the
C3D tower's 3-D convs, which are independent per 16-frame window, and only
the small recurrence (7x7xU state) is sequential in time. So for one
stream the WINDOW axis is split over "data":

    video [B, F, H, W, 3]        (whole on every rank)
      -> clip windows [B*W, 16, H, W, 3], this rank's strip of B*W/n
         (`window_constraint` of `pipeline.extract_and_predict`)
      -> conv5b features of the strip, all-gathered to every rank
         (`stream_constraint`; [B*W, 512, 2, 7, 7] bf16 is small)
      -> recurrence + decoder, replicated (the same maps on every rank)

The frame stream ([15::5], resized) is computed from the whole video on
every rank, so it needs no gather. `make_temporal_sharded_extract` keeps
the features window-sharded instead, each rank's strip of windows, for
streaming them out per rank.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..models.common import GazeModel
from ..ops.collectives import all_gather_cat
from .mesh import DATA_AXIS, Mesh, rank_rows
from .sharding import (_as_tensor, _ensure_params_placed,
                       _on_host_or_device, tower_on)


def make_temporal_sharded_fused_predict(
        gaze_model: GazeModel, mesh: Mesh, *,
        compute_dtype=torch.bfloat16,
        model_parallel: Optional[bool] = None) -> Callable:
    """`fn(c3d_params, video) -> maps [B, T, GH, GW]` with the tower run
    on this rank's strip of the B*(F//16) windows; the maps are the same
    on every rank.

    Requirements (the JAX package's guards): batch*windows divisible by
    the data size, so each rank owns an equal strip, and the frame count F
    too (the JAX package splits the raw frame axis before the fold)."""
    from ..models.pipeline import extract_and_predict

    n_data = mesh.shape[DATA_AXIS]
    towers: dict = {}

    @torch.inference_mode()
    def fn(c3d_params: dict, video_frames) -> torch.Tensor:
        b = video_frames.shape[0]
        n_windows = video_frames.shape[1] // 16
        # the split axis is the FOLDED b*n_windows clip axis, so e.g. 2
        # videos x 4 windows on 8 ranks is valid
        if (b * n_windows) % n_data:
            raise ValueError(
                f"temporal sharding needs batch*windows ({b}*{n_windows}) "
                f"divisible by the data axis ({n_data}); pad the video so "
                f"batch*windows is a multiple of {n_data}")
        if video_frames.shape[1] % n_data:
            raise ValueError(
                f"temporal sharding splits the frame axis "
                f"({video_frames.shape[1]} frames) over the data axis "
                f"({n_data}); frame count must be a multiple of {n_data} "
                f"(add batch so clips, not frames, carry the parallelism, "
                f"or pad frames to a multiple of 16*{n_data})")
        _ensure_params_placed(gaze_model, mesh, model_parallel)
        video = _as_tensor(video_frames, mesh.device)
        return extract_and_predict(
            tower_on(mesh, c3d_params, towers), gaze_model, video,
            compute_dtype=compute_dtype,
            window_constraint=lambda clips: clips[rank_rows(
                clips.shape[0], mesh)],
            stream_constraint=lambda feats: all_gather_cat(
                feats, mesh.data_group, dim=0))

    return fn


def make_temporal_sharded_extract(mesh: Mesh, *,
                                  compute_dtype=torch.bfloat16) -> Callable:
    """`fn(c3d_params, video [B, F, H, W, 3]) -> features [B, W/n, 1024, 7,
    7]`: this rank's strip of each video's W = F//16 windows (windows
    r*W/n .. (r+1)*W/n - 1 on data rank r), left window-sharded: the
    building block for streaming temporally split features out of each
    rank (`models/streaming.py`)."""
    from ..models import c3d as c3d_model

    n_data = mesh.shape[DATA_AXIS]
    towers: dict = {}

    @torch.inference_mode()
    def fn(c3d_params: dict, video_frames) -> torch.Tensor:
        n_windows = video_frames.shape[1] // 16
        # unlike the fused predict (which splits the folded b*n_windows
        # axis and replicates its output), the OUTPUT here stays
        # window-sharded per video, so n_windows itself must split evenly
        if n_windows % n_data:
            raise ValueError(
                f"temporal extract keeps features window-sharded, so "
                f"windows ({n_windows}) must be divisible by the data "
                f"axis ({n_data}); pad the video to a multiple of "
                f"{16 * n_data} frames")
        if video_frames.shape[1] % n_data:
            raise ValueError(
                f"temporal extract splits the frame axis "
                f"({video_frames.shape[1]} frames) over the data axis "
                f"({n_data}); truncate the leftover partial window so the "
                f"frame count is a multiple of {n_data} (whole 16-frame "
                f"windows already satisfy this)")
        video = _on_host_or_device(video_frames)  # only the strip moves
        b = video.shape[0]
        windows = video[:, :n_windows * 16].reshape(
            b, n_windows, 16, *video.shape[2:])
        strip = windows[:, rank_rows(n_windows, mesh)].to(mesh.device)
        k = strip.shape[1]
        clips = c3d_model.preprocess_frames(
            strip.reshape(b * k, 16, *video.shape[2:]))
        feats = c3d_model.apply(tower_on(mesh, c3d_params, towers), clips,
                                feature_layer="conv5b",
                                compute_dtype=compute_dtype)
        return c3d_model.conv5b_to_rgp(feats).reshape(b, k, 1024, 7, 7)

    return fn
