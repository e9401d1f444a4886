"""Synthetic gaze-clip generator: the port's copy of the JAX package's
`data/synthetic.py` (numpy only; the same seed gives the same arrays).

The CRC/Hollywood2 gaze data is an external download (the reference's
`README.md:8-12`); the framework therefore ships a synthetic generator that
follows the exact container formats (SURVEY.md section 7 "dataset
availability") so every pipeline stage can be exercised hermetically.

The generated data is LEARNABLE by construction: a smooth gaze blob walks
around the map over time, the C3D feature map carries a spatially aligned
activation bump at 7x7 scale, and frames carry a brightness bump at image
scale — so models that read either stream can reduce the loss and raise
CC/AUC above chance.
"""

from __future__ import annotations

import numpy as np

from .datasets import ClipDataset, DataSplits


def _gaussian_map(h: int, w: int, cy: np.ndarray, cx: np.ndarray,
                  sigma: float) -> np.ndarray:
    """Batched gaussian bumps: cy/cx [...,] -> [..., h, w]."""
    ys = np.arange(h).reshape((1,) * cy.ndim + (h, 1))
    xs = np.arange(w).reshape((1,) * cx.ndim + (1, w))
    cy = cy[..., None, None]
    cx = cx[..., None, None]
    return np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2.0 * sigma ** 2))


def make_clip_windows(n_clips: int, t: int, *, image_hw=(98, 98),
                      gazemap_hw=(49, 49), n_users: int = 8,
                      seed: int = 0) -> ClipDataset:
    """Generate `n_clips` chunked windows of length `t` in reference layout."""
    rng = np.random.RandomState(seed)
    ih, iw = image_hw
    gh, gw = gazemap_hw

    # random-walk gaze center in [0.15, 0.85] normalized coords
    pos = rng.rand(n_clips, 2) * 0.5 + 0.25
    traj = np.zeros((n_clips, t, 2))
    for step in range(t):
        pos = np.clip(pos + rng.randn(n_clips, 2) * 0.03, 0.15, 0.85)
        traj[:, step] = pos

    cy_g = traj[..., 0] * (gh - 1)
    cx_g = traj[..., 1] * (gw - 1)

    # gazemaps: mean of per-user jittered blobs (users ~= reference's
    # per-user gazemap average, crc_input_data_seq.py:286)
    gazemaps = np.zeros((n_clips, t, gh, gw), np.float32)
    fixationmaps = np.zeros((n_clips, t, gh, gw), np.float32)
    for _ in range(n_users):
        jy = cy_g + rng.randn(n_clips, t) * 1.5
        jx = cx_g + rng.randn(n_clips, t) * 1.5
        jy = np.clip(jy, 0, gh - 1)
        jx = np.clip(jx, 0, gw - 1)
        gazemaps += _gaussian_map(gh, gw, jy, jx, sigma=2.0).astype(np.float32)
        # fixation = one-hot at the rounded jittered point (summed over users,
        # crc_input_data_seq.py:271)
        iy = np.round(jy).astype(int)
        ix = np.round(jx).astype(int)
        for ci in range(n_clips):
            fixationmaps[ci, np.arange(t), iy[ci], ix[ci]] += 1.0
    gazemaps /= n_users
    gazemaps += 1e-4  # keep probability normalization well-defined

    # C3D stream: 1024-channel 7x7 maps; a fixed random channel mixture
    # carries the gaze bump at 7x7 resolution plus noise. The mixture is
    # drawn from a FIXED seed independent of `seed`: it plays the role of
    # the (frozen) C3D feature encoding, which is the SAME network for
    # every split — per-split mixtures made the corpus learnable but not
    # generalizable (a model fit on train read channels that are pure
    # noise on valid; round-4 convergence rehearsal caught it as
    # negative CC on the held-out split).
    cy7 = traj[..., 0] * 6.0
    cx7 = traj[..., 1] * 6.0
    bump7 = _gaussian_map(7, 7, cy7, cx7, sigma=1.0).astype(np.float32)
    enc_rng = np.random.RandomState(1234)
    channel_gain = (enc_rng.rand(1024) < 0.25).astype(np.float32) * \
        enc_rng.rand(1024).astype(np.float32)
    c3d = rng.rand(n_clips, t, 1024, 7, 7).astype(np.float32) * 0.1
    c3d += channel_gain[None, None, :, None, None] * bump7[:, :, None, :, :]

    # frames: gray noise + brightness bump at the gaze point
    cyi = traj[..., 0] * (ih - 1)
    cxi = traj[..., 1] * (iw - 1)
    bump_img = _gaussian_map(ih, iw, cyi, cxi, sigma=8.0).astype(np.float32)
    frames = rng.rand(n_clips, t, ih, iw, 1).astype(np.float32) * 0.3
    frames = frames + bump_img[..., None] * 0.7
    frames = np.clip(np.repeat(frames, 3, axis=-1), 0.0, 1.0)

    # pupil size: a LEARNABLE function of the observable scene — it tracks
    # the gaze target's vertical position (which the C3D stream's bump
    # encodes), plus observation noise. The legacy pupil-head prototypes
    # (`models/gaze_legacy.py`, reference `model_gru_rcn.py:135-141`)
    # regress this; a random signal would make their pupil loss
    # irreducible and the head's learning undemonstrable.
    pupils = (0.25 + 0.5 * traj[..., 0]
              + rng.randn(n_clips, t) * 0.02).astype(np.float32)
    clipnames = [f"synthetic_{seed}_{i:04d}" for i in range(n_clips)]

    return ClipDataset(frames=frames, gazemaps=gazemaps,
                       fixationmaps=fixationmaps, c3d=c3d, pupils=pupils,
                       clipnames=clipnames)


def make_splits(n_train: int = 16, n_valid: int = 8, n_test: int = 8,
                t: int = 8, seed: int = 0, **kwargs) -> DataSplits:
    return DataSplits(
        train=make_clip_windows(n_train, t, seed=seed, **kwargs),
        valid=make_clip_windows(n_valid, t, seed=seed + 1, **kwargs),
        test=make_clip_windows(n_test, t, seed=seed + 2, **kwargs),
    )
