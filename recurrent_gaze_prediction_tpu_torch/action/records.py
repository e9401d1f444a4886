"""Frame records for the action-classification task: the port's copy of
the JAX package's `action/records.py` (numpy only).

Sharded compressed npz files in place of the reference's TFRecords
(`models/create_tfrecords.py:157-203`, `models/read_tfrecord.py:6-69`),
with the same per-frame fields and fixed shapes:

    c3d          [N, 1024, 7, 7]
    frames       [N, 98, 98, 3]
    gaze_pred    [N, 49, 49]   (model-predicted gazemaps)
    gaze_gt      [N, 49, 49]
    labels       [N, 13]       (multi-hot Hollywood2 classes)

plus a Hollywood2 `ClipSets` label parser
(`models/create_tfrecords.py:58-101`).
"""

from __future__ import annotations

import glob
import os
from collections import OrderedDict
from typing import Iterator, Optional, Sequence

import numpy as np

FIELDS = ("c3d", "frames", "gaze_pred", "gaze_gt", "labels")
NUM_CLASSES = 13


def write_record_shard(path: str, **fields) -> None:
    missing = set(FIELDS) - set(fields)
    if missing:
        raise ValueError(f"missing fields: {missing}")
    n = len(fields["c3d"])
    for key in FIELDS:
        assert len(fields[key]) == n, key
    np.savez_compressed(path, **{k: np.asarray(fields[k]) for k in FIELDS})


def read_record_shard(path: str) -> dict:
    blob = np.load(path)
    return {k: blob[k] for k in FIELDS}


def iter_record_batches(paths: Sequence[str], batch_size: int,
                        shuffle_seed: Optional[int] = None,
                        drop_remainder: bool = True) -> Iterator[dict]:
    """Stream fixed-size batches across shards (`read_tfrecord.py:55-69`
    equivalent)."""
    rng = (np.random.RandomState(shuffle_seed)
           if shuffle_seed is not None else None)
    paths = list(paths)
    if rng is not None:
        rng.shuffle(paths)
    buffers = {k: [] for k in FIELDS}
    for path in paths:
        shard = read_record_shard(path)
        n = len(shard["c3d"])
        order = rng.permutation(n) if rng is not None else np.arange(n)
        for k in FIELDS:
            buffers[k].append(shard[k][order])
        total = sum(len(b) for b in buffers["c3d"])
        if total >= batch_size:
            # concatenate the carried tail with this shard ONCE and slice
            # by offset — re-concatenating the whole residue per yielded
            # batch was O(N^2/B) copying over a shard
            stacked = {k: np.concatenate(buffers[k]) for k in FIELDS}
            offset = 0
            while total - offset >= batch_size:
                yield {k: stacked[k][offset:offset + batch_size]
                       for k in FIELDS}
                offset += batch_size
            for k in FIELDS:
                buffers[k] = [stacked[k][offset:]]
    if not drop_remainder and sum(len(b) for b in buffers["c3d"]):
        yield {k: np.concatenate(buffers[k]) for k in FIELDS}


def load_clipset_labels(clipsets_dir: str, split: str) -> OrderedDict:
    """Hollywood2 ClipSets parser (`create_tfrecords.py:58-101` /
    `action_classification.py:103-147`): returns clip -> list of class ids,
    classes ordered by sorted ClipSets filename."""
    if split == "train":
        pattern = os.path.join(clipsets_dir, "*_train*")
    elif split == "test":
        pattern = os.path.join(clipsets_dir, "*test*")
    else:
        raise NameError(split)
    labels: OrderedDict = OrderedDict()
    for class_id, text_file in enumerate(sorted(glob.glob(pattern))):
        with open(text_file) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 2:
                    continue
                clip, label = parts[0], parts[-1]
                if label.startswith("1"):
                    labels.setdefault(clip, []).append(class_id)
    return labels


def multi_hot(class_ids: Sequence[int],
              num_classes: int = NUM_CLASSES) -> np.ndarray:
    vec = np.zeros(num_classes, np.float32)
    vec[list(class_ids)] = 1.0
    return vec
