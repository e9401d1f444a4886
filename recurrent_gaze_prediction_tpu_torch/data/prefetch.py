"""Host-to-device input batches, inline or prefetched on a worker thread:
the port's counterpart of the JAX package's `data/prefetch.py`.

The reference feeds every batch synchronously (`models/gaze_rnn.py:523-531`).
`prefetch_batches` keeps a small queue of batches already on the card
ahead of the train loop, so the host's cast and copy of batch k+1 overlap
the step on batch k. On CUDA each batch is cast into pinned host memory in
one pass and copied with `non_blocking=True` on a side stream; the
consumer's stream waits on an event recorded after the copy. No model code
runs on the worker thread. Over a mesh the worker copies only this rank's
rows (`parallel.shard_batch`) to its device.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Iterator, Optional, Union

import numpy as np
import torch

from ..train.profiler import count, span
from ..utils import resolve_device
from .datasets import ClipDataset


def stream_casts(dtype: Optional[torch.dtype]) -> Optional[dict]:
    """The `cast` of `device_put_batch` that casts the two big input
    streams, frames and c3d, to `dtype` (None: no cast)."""
    return None if dtype is None else {"frames": dtype, "c3d": dtype}


def device_put_batch(batch: dict, device: torch.device,
                     cast: Optional[dict] = None) -> dict:
    """A host batch as tensors on `device`. `cast` maps batch keys to
    dtypes applied on the HOST first (frames and c3d to bf16 halve the
    copy; the models cast them to the compute dtype anyway). Clip names and
    ragged object arrays (which no step reads) are dropped.

    On a CUDA device each array is cast into a pinned host buffer in one
    pass and copied with `non_blocking=True` on the current stream; the
    caching host allocator keeps the buffer until that copy is done."""
    pin = device.type == "cuda"
    out = {}
    for key, value in batch.items():
        if key == "clipnames" or getattr(value, "dtype", None) == np.dtype(
                object):
            continue
        host = torch.from_numpy(np.ascontiguousarray(value))
        dtype = cast.get(key, host.dtype) if cast else host.dtype
        if pin:
            staged = torch.empty(host.shape, dtype=dtype, pin_memory=True)
            out[key] = staged.copy_(host).to(device, non_blocking=True)
        else:
            out[key] = host.to(device=device, dtype=dtype)
    count("input.bytes", sum(t.nbytes for t in out.values()))
    return out


def prefetch_batches(dataset: ClipDataset, batch_size: int, *,
                     device: Optional[Union[str, torch.device]] = None,
                     buffer_size: int = 2, cast: Optional[dict] = None,
                     max_batches: Optional[int] = None,
                     mesh=None) -> Iterator[dict]:
    """Batches of `dataset.next_batch(batch_size)` on `device` (None = the
    card; raises without CUDA), produced ahead by a worker thread that
    keeps at most `buffer_size` of them queued; at most `max_batches` in
    all (None: no end). A worker exception is raised in the consumer.
    Closing the generator early (or dropping it) stops the worker. With a
    `mesh` (`parallel.make_mesh`) each batch is this rank's rows of the
    global batch on the mesh's device, which the mesh's steps take as they
    are."""
    if mesh is not None:
        from ..parallel.mesh import shard_batch

        return _prefetch(dataset, batch_size, mesh.device, buffer_size,
                         lambda batch: shard_batch(batch, mesh, cast),
                         max_batches)
    dev = resolve_device(device)
    return _prefetch(dataset, batch_size, dev, buffer_size,
                     lambda batch: device_put_batch(batch, dev, cast),
                     max_batches)


def _prefetch(dataset: ClipDataset, batch_size: int, device: torch.device,
              buffer_size: int, put, max_batches: Optional[int]
              ) -> Iterator[dict]:
    q: queue.Queue = queue.Queue(maxsize=buffer_size)
    stop = threading.Event()
    cuda = device.type == "cuda"

    def put_or_abandon(item) -> bool:
        """A blocking put that gives up once the consumer has left: a bare
        q.put would pin this thread, and a batch on the card, for the life
        of the process when the consumer abandons the generator."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            side = torch.cuda.Stream(device) if cuda else None
            produced = 0
            while not stop.is_set():
                if max_batches is not None and produced >= max_batches:
                    break
                batch = dataset.next_batch(batch_size)
                with span("input.put", request=produced):
                    if cuda:
                        with torch.cuda.stream(side):
                            tensors = put(batch)
                            ready = torch.cuda.Event()
                            ready.record(side)
                        item = (tensors, ready)
                    else:
                        item = (put(batch), None)
                if not put_or_abandon(item):
                    return
                produced += 1
            put_or_abandon(None)
        except Exception as exc:  # re-raised in the consumer; a dead
            # worker with no sentinel would leave q.get() blocked forever
            put_or_abandon(exc)

    thread = threading.Thread(target=worker, daemon=True,
                              name="prefetch_batches")
    thread.start()
    try:
        for taken in itertools.count():  # the worker's `produced`, in order
            with span("input.wait", request=taken):
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                tensors, ready = item
                if ready is not None:
                    consumer = torch.cuda.current_stream(device)
                    consumer.wait_event(ready)
                    for t in tensors.values():
                        # copied on the side stream, read on this one: the
                        # allocator must not reuse it before this stream
                        # is done
                        t.record_stream(consumer)
            yield tensors
    finally:
        stop.set()
        while True:  # drain, so that a blocked put sees `stop`
            try:
                q.get_nowait()
            except queue.Empty:
                break
        thread.join(timeout=5.0)
