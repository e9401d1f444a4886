"""The first steps of training from raw video with the C3D tower frozen,
plainly: the float32 tower (`tower.py`) under the release's video protocol
(`video.py`) gives each batch's conv5b features, and the gaze head trains
on them as `train.steps` trains it on precomputed features.

The half-batch flip mirrors the video (the tower sees the mirrored pixels,
so a mirrored clip's features are not the mirror of its features) and its
maps. The flip is the first draw of each step, so the flips of all the
steps are found first by replaying the generator's draws (`train.draws`)
on a copy of it; `train.steps` then draws the same numbers from the
generator itself, with its own flip turned off.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import tower, train, video


def steps(cfg: dict, tower_params: dict, params: dict, batches: list,
          generator: torch.Generator, *, rounding=None,
          fault: Optional[str] = None) -> dict:
    """Train the head `params` through `batches` ({"video": [B, F, H, W, 3]
    pixels 0..255 at the tower's 128x171, "gazemaps": [B, T, 49, 49]} on
    the generator's device) -> `train.steps`' result. `rounding` rounds the
    tower's contractions too."""
    model, c3d = cfg["model"], cfg["c3d"]
    keep = model["dropout_keep_prob"]
    replay = torch.Generator(device=generator.device)
    replay.set_state(generator.get_state())

    def tower_fn(clips):
        return tower.tower_f32(tower_params, clips, rounding=rounding)

    fed = []
    for batch in batches:
        pixels, gaze = batch["video"], batch["gazemaps"].float()
        b, t = gaze.shape[:2]
        flip, _, _ = train.draws(b, t, model["dim_cnn_proj"], keep, replay)
        if model["use_flip_batch"]:
            pixels = torch.where(flip[:, None, None, None, None],
                                 pixels.flip(3), pixels)
            gaze = torch.where(flip[:, None, None, None], gaze.flip(3), gaze)
        with torch.no_grad():
            feats = video.features(tower_fn, pixels, c3d["crop"],
                                   c3d["mean_pixel"])
        fed.append({"c3d": feats, "gazemaps": gaze})
    unflipped = {**cfg, "model": {**model, "use_flip_batch": False}}
    return train.steps(unflipped, params, fed, generator, rounding=rounding,
                       fault=fault)
