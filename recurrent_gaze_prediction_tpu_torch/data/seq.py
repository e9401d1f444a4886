"""Sequence chunking: fixed-length windows out of variable-length clips.
The port's copy of the JAX package's `data/seq.py`.

`seq2batch` is the reference's (`crc_input_data_seq.py:383-420`): a clip
longer than SEQ_LEN splits into floor(L/T) equal windows plus one
overlapping tail window `data[-T:]`; a shorter clip is tiled along time
until it reaches T. SEQ_LEN=42 (`crc_input_data_seq.py:486`).
"""

from __future__ import annotations

from typing import Union

import numpy as np

SEQ_LEN = 42
FRAME_OFFSET = 15   # frame subsampling [15::5], crc_input_data_seq.py:186
FRAME_STRIDE = 5


def subsample_indices(n_frames: int, offset: int = FRAME_OFFSET,
                      stride: int = FRAME_STRIDE) -> np.ndarray:
    return np.arange(offset, n_frames, stride)


def seq2batch(data: Union[np.ndarray, list], seq_len: int = SEQ_LEN) -> list:
    """Chunk one clip's stream into fixed-length windows.

    Returns a list of windows, each of length `seq_len` along axis 0.
    """
    data_len = len(data)
    is_list = isinstance(data, list)
    seqs = []
    if data_len > seq_len:
        num_parts = data_len // seq_len
        eq_parts = data[:num_parts * seq_len]
        for i in range(0, num_parts * seq_len, seq_len):
            seqs.append(eq_parts[i:i + seq_len])
        seqs.append(data[-seq_len:])  # overlapping tail window
    else:
        tile_count = seq_len // data_len + 1
        if is_list:
            repeated = (data * tile_count)[:seq_len]
        else:
            reps = [tile_count] + [1] * (data.ndim - 1)
            repeated = np.tile(data, reps)[:seq_len]
        seqs.append(repeated)
    return seqs


def chunk_streams(streams: dict, seq_len: int = SEQ_LEN) -> dict:
    """Apply seq2batch to every stream of one clip; returns stacked arrays
    keyed like the input, [n_windows, seq_len, ...]."""
    out = {}
    for key, value in streams.items():
        windows = seq2batch(value, seq_len)
        if isinstance(value, list):
            out[key] = windows
        else:
            out[key] = np.stack(windows, axis=0)
    return out
