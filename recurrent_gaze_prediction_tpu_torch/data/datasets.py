"""In-memory clip datasets: the port's copy of the JAX package's
`data/datasets.py` (numpy only), the equivalent of the reference's
`CRCDataSet` / `CRCDataSplits` (`crc_input_data_seq.py:64-156`).

A `ClipDataset` holds fixed-shape arrays for chunked clip windows:
    frames       [N, T, IH, IW, 3]  float32 in [0, 1]
    gazemaps     [N, T, GH, GW]     float32 (user-averaged, blurred)
    fixationmaps [N, T, FH, FW]     float32 (summed one-hot fixations)
    c3d          [N, T, 1024, 7, 7] float32
    pupils       [N, T]             float32
    clipnames    [N]                list[str]

Unlike the reference's object arrays + feed_dict, batches come out as dense
NumPy ready for the copy to the device; `next_batch` keeps the reference's epoch
semantics (restart from 0 when the epoch is exhausted,
`crc_input_data_seq.py:132-156`).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

BATCH_KEYS = ("frames", "gazemaps", "fixationmaps", "c3d", "pupils")


@dataclasses.dataclass
class ClipDataset:
    frames: np.ndarray
    gazemaps: np.ndarray
    fixationmaps: np.ndarray
    c3d: np.ndarray
    pupils: np.ndarray
    clipnames: list

    def __post_init__(self):
        n = len(self.frames)
        for key in BATCH_KEYS:
            assert len(getattr(self, key)) == n, key
        self._index = 0
        self.epochs_completed = 0

    def __len__(self) -> int:
        return len(self.frames)

    def __repr__(self) -> str:
        return f"ClipDataset({len(self)} clip windows, T={self.frames.shape[1]})"

    def shuffle(self, seed: int = 3027300) -> None:
        """Deterministic shuffle (reference seed, `crc_input_data_seq.py:110`)."""
        perm = np.random.RandomState(seed).permutation(len(self))
        for key in BATCH_KEYS:
            setattr(self, key, getattr(self, key)[perm])
        self.clipnames = [self.clipnames[i] for i in perm]

    def reset(self) -> None:
        """Rewind the batch cursor to the start (checkpoint sweeps must
        score every checkpoint on the SAME data window)."""
        self._index = 0

    def next_batch(self, batch_size: int) -> dict:
        start = self._index
        self._index += batch_size
        if self._index > len(self):
            self.epochs_completed += 1
            start = 0
            self._index = batch_size
            assert batch_size <= len(self), \
                f"batch_size {batch_size} > dataset size {len(self)}"
        end = self._index
        batch = {key: getattr(self, key)[start:end] for key in BATCH_KEYS}
        batch["clipnames"] = self.clipnames[start:end]
        return batch

    def iter_batches(self, batch_size: int,
                     max_instances: Optional[int] = None) -> Iterator[dict]:
        """One deterministic pass over (up to max_instances of) the dataset
        (reference `generate`, `models/gaze_rnn.py:583-591`).

        Unlike the reference, this does NOT ride `next_batch`'s persistent
        wrap-around cursor: that re-yielded the head batch and silently
        dropped the tail whenever n % batch_size != 0 — corrupting
        `cli/create_records` shards (duplicated head frames, missing tail)
        and double-counting frames in every evaluation mean. Each window is
        yielded exactly once; the final batch may be short (one extra jit
        compile for the tail shape on offline surfaces in the JAX package)."""
        n = len(self)
        if max_instances is not None:
            n = min(n, max_instances)
        for start in range(0, n, batch_size):
            end = min(start + batch_size, n)
            batch = {key: getattr(self, key)[start:end] for key in BATCH_KEYS}
            batch["clipnames"] = self.clipnames[start:end]
            yield batch


@dataclasses.dataclass
class DataSplits:
    train: Optional[ClipDataset] = None
    valid: Optional[ClipDataset] = None
    test: Optional[ClipDataset] = None

    def __len__(self) -> int:
        return sum(len(s) for s in (self.train, self.valid, self.test)
                   if s is not None)

    def __repr__(self) -> str:
        parts = [f" {name} : {len(split)}"
                 for name, split in (("train", self.train),
                                     ("valid", self.valid),
                                     ("test", self.test)) if split is not None]
        return "<DataSplits\n" + "\n".join(parts) + "\n>"


def empty_dataset(t: int = 1, image_hw: tuple[int, int] = (98, 98),
                  gazemap_hw: tuple[int, int] = (49, 49)) -> ClipDataset:
    """Zero-length dataset, for checkpoint-only model loading (reference's
    dummy `CRCDataSplits()` pattern, `models/evaluate_gaze.py:97-99`)."""
    ih, iw = image_hw
    gh, gw = gazemap_hw
    return ClipDataset(
        frames=np.zeros((0, t, ih, iw, 3), np.float32),
        gazemaps=np.zeros((0, t, gh, gw), np.float32),
        fixationmaps=np.zeros((0, t, gh, gw), np.float32),
        c3d=np.zeros((0, t, 1024, 7, 7), np.float32),
        pupils=np.zeros((0, t), np.float32),
        clipnames=[],
    )
