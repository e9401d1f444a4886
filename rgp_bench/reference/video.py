"""Raw video to gaze maps, the reference release's protocol: a C3D feature
per non-overlapping 16-frame window, T = min(windows, frames from 15 on
every 5th), the gaze model over those T features."""

from __future__ import annotations

import torch

from . import head, tower

WINDOW, OFFSET, STRIDE = 16, 15, 5
CLIPS_PER_CALL = 8  # the float64 int8 sums of eight clips fit in a few GB


def timesteps(frames: int) -> int:
    return min(frames // WINDOW, max(0, -(-(frames - OFFSET) // STRIDE)))


def features(tower_fn, video: torch.Tensor, crop: int, mean_pixel: float
             ) -> torch.Tensor:
    """[B, F, H, W, 3] pixels -> [B, T, 1024, 7, 7] conv5b features, the
    tower `tower_fn(clips) -> conv5b` run CLIPS_PER_CALL clips at a
    time."""
    b, f = video.shape[:2]
    n = f // WINDOW
    frames = video[:, :n * WINDOW].reshape(b * n, WINDOW, *video.shape[2:])
    out = torch.cat([
        tower.fold(tower_fn(tower.preprocess(frames[i:i + CLIPS_PER_CALL],
                                             crop, mean_pixel)))
        for i in range(0, b * n, CLIPS_PER_CALL)])
    return out.reshape(b, n, *out.shape[1:])[:, :timesteps(f)]


def gaze_maps(tower_fn, head_weights: dict, cell: str, video: torch.Tensor,
              crop: int, mean_pixel: float, rounding=None) -> torch.Tensor:
    """[B, F, H, W, 3] pixels -> maps [B, T, 49, 49]."""
    c3d = features(tower_fn, video, crop, mean_pixel)
    return head.maps(head_weights, cell, c3d, rounding=rounding)
