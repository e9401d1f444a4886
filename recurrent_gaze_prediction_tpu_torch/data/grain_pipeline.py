"""Grain-based host input pipeline: the port's counterpart of the JAX
package's `data/grain_pipeline.py`.

The reference feeds batches synchronously through feed_dict from in-RAM
object arrays. This module wraps a `ClipDataset` (or any record source)
into a `grain.DataLoader` with deterministic global shuffling, sharding
across hosts, worker processes and checkpointable iteration state: a
multi-epoch input path whose batches `train.fit(train_iterator=...)`
takes (numpy dicts; `fit` moves them to the model's device). grain is an
optional dependency, imported when a loader is made.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from .datasets import BATCH_KEYS, ClipDataset


class _ClipSource:
    """Random-access view over a ClipDataset (grain's
    RandomAccessDataSource protocol: __len__ + __getitem__)."""

    def __init__(self, dataset: ClipDataset):
        self._data = dataset

    def __len__(self) -> int:
        return len(self._data)

    def __getitem__(self, index: int) -> dict:
        return {key: getattr(self._data, key)[index] for key in BATCH_KEYS}


def make_dataloader(dataset: ClipDataset, batch_size: int, *,
                    seed: int = 0, shuffle: bool = True,
                    num_epochs: Optional[int] = None,
                    worker_count: int = 0,
                    shard_index: Optional[int] = None,
                    shard_count: Optional[int] = None):
    """A grain DataLoader over clip windows, in the same order as the JAX
    package's for the same seed. worker_count > 0 assembles records in
    subprocesses; shard_index / shard_count slice the dataset per host."""
    try:
        import grain.python as gp
    except ImportError as e:
        raise ImportError("make_dataloader needs the grain package") from e

    if shard_index is None or shard_count is None:
        sharding = gp.NoSharding()
    else:
        sharding = gp.ShardOptions(shard_index=shard_index,
                                   shard_count=shard_count,
                                   drop_remainder=True)
    sampler = gp.IndexSampler(num_records=len(dataset), shuffle=shuffle,
                              seed=seed, num_epochs=num_epochs,
                              shard_options=sharding)
    return gp.DataLoader(
        data_source=_ClipSource(dataset), sampler=sampler,
        operations=[gp.Batch(batch_size=batch_size, drop_remainder=True)],
        worker_count=worker_count)


def iterate_batches(loader) -> Iterator[dict]:
    """Yield dict batches of contiguous numpy arrays."""
    for batch in loader:
        yield {k: np.ascontiguousarray(v) for k, v in batch.items()}
