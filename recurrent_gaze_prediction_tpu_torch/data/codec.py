"""C3D binary blob codec and `.c3d` feature files: the port's copy of the
JAX package's `data/codec.py` (numpy and pickle only).

The blob format is the C3D Caffe tools' (the reference's
`extract_C3D_features.py:13-76`): a 5-int32 header [num, channels, length,
height, width], then the float32 payload in row-major (num, channel,
length, h, w) order. A video's features are the pickled float32 array of
its per-window blobs (`extract_C3D_features.py:763-798`), read back and
reshaped to [T, 1024, 7, 7] with the (channel=512, length=2) axes folded
channel-major (`models/gaze_rnn.py:494-497`).

`write_c3d_file` pickles with protocol 2 and `read_c3d_file` unpickles
with latin1, so the reference's Python 2 files read here, and a file
written by either package reads back identically in the other. Unpickling
runs code from the file: read only `.c3d` files this pipeline wrote.
"""

from __future__ import annotations

import pickle
import struct
from typing import Sequence

import numpy as np

_HEADER = struct.Struct("<5i")


def write_binary_blob(filename: str, blob: np.ndarray) -> None:
    """Write a 5-D [n, c, l, h, w] float32 blob in C3D binary format."""
    blob = np.ascontiguousarray(blob, dtype=np.float32)
    if blob.ndim != 5:
        raise ValueError(f"blob must be 5-D [n,c,l,h,w], got {blob.shape}")
    with open(filename, "wb") as f:
        f.write(_HEADER.pack(*blob.shape))
        f.write(blob.tobytes())


def read_binary_blob(filename: str) -> np.ndarray:
    """Read a C3D binary blob -> float32 array [n, c, l, h, w]."""
    with open(filename, "rb") as f:
        header = f.read(_HEADER.size)
        if len(header) != _HEADER.size:
            raise IOError(f"truncated blob header in {filename}")
        shape = _HEADER.unpack(header)
        count = int(np.prod(shape))
        raw = f.read(count * 4)
        if len(raw) != count * 4:
            raise IOError(f"truncated blob payload in {filename}")
        data = np.frombuffer(raw, dtype="<f4", count=count)
    return data.reshape(shape).astype(np.float32)


def write_c3d_file(filename: str, window_blobs: Sequence[np.ndarray]) -> None:
    """Aggregate per-window blobs into the pickled `.c3d` container
    (`extract_C3D_features.py:794-798`, pickle protocol 2)."""
    arr = np.array(window_blobs, dtype=np.float32)
    with open(filename, "wb") as f:
        pickle.dump(arr, f, protocol=2)


def read_c3d_file(filename: str) -> np.ndarray:
    """Read a `.c3d` pickle -> [T, 512, 2, 7, 7] (or squeezed variants)."""
    with open(filename, "rb") as f:
        arr = pickle.load(f, encoding="latin1")
    return np.asarray(arr, dtype=np.float32)


def fold_conv5b(features: np.ndarray) -> np.ndarray:
    """[..., 512, 2, 7, 7] -> [..., 1024, 7, 7], channel-major fold: flat
    channel = c3d_channel * 2 + temporal_slot (the reference's
    `reshape(-1, 1024, 7, 7)`, `models/gaze_rnn.py:497`)."""
    features = np.asarray(features)
    lead = features.shape[:-4]
    return features.reshape(*lead, 1024, 7, 7)


def load_c3d_for_model(filename: str) -> np.ndarray:
    """`.c3d` file -> [T, 1024, 7, 7] for the gaze models (inner singleton
    axes squeezed, temporal slot folded into the channels).

    The leading WINDOW axis is never squeezed: a single-window clip
    ([1, 1, 512, 2, 7, 7] or [1, 512, 2, 7, 7]) comes back as
    [1, 1024, 7, 7]."""
    arr = read_c3d_file(filename)
    inner = tuple(i for i, s in enumerate(arr.shape) if s == 1 and i != 0)
    if inner:
        arr = arr.squeeze(axis=inner)
    if arr.shape[-2:] != (7, 7):
        raise ValueError(f"unexpected c3d spatial shape: {arr.shape}")
    if arr.ndim == 4 and arr.shape[1] == 1024:
        return arr
    return fold_conv5b(arr)
