"""Gazemap preprocessing: multi-resolution one-hot maps, fixations, blur.
The port's copy of the JAX package's `data/gazemap.py` (numpy and
scipy.ndimage; the h5py objects come in from the caller).

The reference's offline stage (`process_gazemap.py`, `add_gazemap.py`) and
its in-loader blur (`crc_input_data_seq.py:41-52`):

  * `resize_onehot_tensor`: nearest-point projection of one-hot gaze maps
    to a smaller grid (`process_gazemap.py:11-32`)
  * `fixation_points`: the same projection plus the sparse (t, r, c)
    coordinate streams stored as `fixation_{t,r,c}`
    (`process_gazemap.py:35-58`)
  * `process_mat_file`: mutate an HDF5 gaze .mat in place, adding
    gazemap49x49 / gazemap48x48 / fixation* keys and deleting all-zero
    users (`process_gazemap.py:61-137`)
  * `fill_gazemap`: forward-fill frames with no gaze
    (`crc_input_data_seq.py:159-166`, `add_gazemap.py:57-74`)
  * `apply_gaussian_filter`: per-frame Gaussian blur + per-frame min-max
    normalization, with the resolution-dependent sigma table
    (`crc_input_data_seq.py:225-241`)
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.ndimage

# (gazemap_h, gazemap_w) -> (mat key, gaussian sigma); None-None = original
# scale (`crc_input_data_seq.py:225-241`)
GAZEMAP_KEYS = {
    (7, 7): ("gazemap7x7", 0.3),
    (14, 14): ("gazemap7x7", 0.6),
    (49, 49): ("gazemap49x49", 2.0),
    (48, 48): ("gazemap48x48", 2.0),
    (None, None): ("gazemap", 19.0),
}


def gazemap_key_and_sigma(gazemap_height: Optional[int],
                          gazemap_width: Optional[int]) -> tuple[str, float]:
    key = (gazemap_height, gazemap_width)
    if key not in GAZEMAP_KEYS:
        raise ValueError(f"Unsupported gazemap shape: {key}")
    return GAZEMAP_KEYS[key]


def resize_onehot_tensor(x: np.ndarray,
                         target_shape: tuple[int, int]) -> np.ndarray:
    """[T, H1, W1] one-hot -> [T, H2, W2] bool via rounded linear projection
    of each active cell (`process_gazemap.py:11-32`), vectorized."""
    assert x.ndim == 3 and len(target_shape) == 2
    t_dim, h1, w1 = x.shape
    h2, w2 = target_shape
    ret = np.zeros((t_dim, h2, w2), dtype=bool)
    ts, rs, cs = np.nonzero(x > 0)
    if ts.size:
        r2 = np.round(rs * (h2 - 1.0) / max(h1 - 1.0, 1.0) + 1e-9).astype(int)
        c2 = np.round(cs * (w2 - 1.0) / max(w1 - 1.0, 1.0) + 1e-9).astype(int)
        ret[ts, r2, c2] = True
    return ret


def fixation_points(x: np.ndarray, target_shape: tuple[int, int]
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Projected fixation map + sparse (t, r, c) coordinate streams at the
    ORIGINAL resolution (`process_gazemap.py:35-58` stores the raw where()
    outputs as fixation_{t,r,c})."""
    fixmap = resize_onehot_tensor(x, target_shape)
    ts, rs, cs = np.nonzero(x > 0)
    return fixmap, ts, rs, cs


def fill_gazemap(gazemap: np.ndarray) -> np.ndarray:
    """Forward-fill all-zero frames from the previous frame, in place
    (`crc_input_data_seq.py:159-166`).

    An all-zero FIRST frame is back-filled from the earliest non-zero
    frame — the reference's `gazemap[i-1]` at i=0 wraps Python-style to
    the LAST frame, leaking future gaze into frame 0 (and leaving frame
    0 zero when the last frame is zero too); prefer
    `fill_missing_frames` for the fully vectorized variant.
    """
    if len(gazemap) and gazemap[0].sum() == 0:
        sums = gazemap.reshape(len(gazemap), -1).sum(axis=1)
        nonzero = np.nonzero(sums)[0]
        if nonzero.size:
            gazemap[0] = gazemap[nonzero[0]]
    for i in range(1, len(gazemap)):
        if gazemap[i].sum() == 0:
            gazemap[i] = gazemap[i - 1]
    return gazemap


def fill_missing_frames(gazemap: np.ndarray) -> np.ndarray:
    """`add_missing_frame` equivalent (`add_gazemap.py:57-74`): back-fill a
    zero FIRST frame from the earliest non-zero frame, then forward-fill
    every later zero frame. Vectorized; raises if all frames are empty."""
    sums = gazemap.reshape(len(gazemap), -1).sum(axis=1)
    nonzero = np.nonzero(sums)[0]
    if nonzero.size == 0:
        raise ValueError("all frames are zero; user should have been deleted")
    if sums[0] == 0:
        gazemap[0] = gazemap[nonzero[0]]
    for i in range(1, len(gazemap)):
        if gazemap[i].sum() == 0:
            gazemap[i] = gazemap[i - 1]
    return gazemap


def apply_gaussian_filter(gazemaps: np.ndarray, sigma: float) -> np.ndarray:
    """Per-frame 2-D Gaussian blur, each frame min-max normalized to [0, 1]
    afterwards; all-zero frames left untouched (`crc_input_data_seq.py:
    41-52`). In-place update, like the reference."""
    assert gazemaps.ndim == 3
    for t in range(len(gazemaps)):
        g = scipy.ndimage.gaussian_filter(gazemaps[t], sigma)
        g = g.astype(np.float32)
        if g.sum() == 0:
            continue
        g -= g.min()
        g /= g.max()
        gazemaps[t] = g
    return gazemaps


def process_user_group(user_data, force: bool = False) -> None:
    """Add the derived keys to one user's HDF5 group (idempotent,
    `process_gazemap.py:77-136`)."""
    raw = np.asarray(user_data["gazemap"])

    def put(key, value):
        if force and key in user_data:
            del user_data[key]
        if key not in user_data:
            user_data[key] = value

    fixmap49, ts, rs, cs = fixation_points(raw, (49, 49))
    put("fixation", fixmap49)
    put("fixation49x49", fixmap49)
    put("fixation48x48", fixation_points(raw, (48, 48))[0])
    put("gazemap49x49", resize_onehot_tensor(raw, (49, 49)))
    put("gazemap48x48", resize_onehot_tensor(raw, (48, 48)))
    put("gazemap7x7", resize_onehot_tensor(raw, (7, 7)))
    put("fixation_t", ts)
    put("fixation_r", rs)
    put("fixation_c", cs)


def process_mat_file(mat_file, force: bool = False) -> None:
    """`handle` equivalent: process every user group in an open h5py file,
    deleting users whose raw gazemap is all-zero
    (`process_gazemap.py:61-137`)."""
    root = list(mat_file.values())[0]
    for user_name in list(root.keys()):
        user_data = root[user_name]
        if "gazemap" not in user_data:
            continue
        if np.asarray(user_data["gazemap"]).sum() == 0:
            del root[user_name]
            continue
        process_user_group(user_data, force=force)
