"""Dynamic micro-batching front-end for serving.

The port's copy of the JAX package's `serving/batcher.py` (it imports
numpy only). Single-clip requests are coalesced into one device call: the
first request opens a batching window, later arrivals join until
`max_batch` or `max_wait_ms`, the merged batch runs once, and each caller
gets its slice back via a Future.

Batch sizes are padded up to power-of-two buckets, so the kernels and
library calls below see O(log max_batch) distinct shapes instead of one
per request count.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Optional, Sequence

import numpy as np


def _bucket(n: int, max_batch: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


class DynamicBatcher:
    """Thread-safe micro-batcher around `predict_fn(*arrays) -> outputs`.

    Contract: each request is ONE clip — `submit` takes per-clip arrays
    WITHOUT a batch dimension (e.g. (frames [T,H,W,3], c3d [T,1024,7,7])
    for the features path, or (video [F,H,W,3],) for the fused path).
    The batcher stacks them, calls `predict_fn` on batch-leading arrays,
    and each Future resolves to that clip's slice (batch dim removed).
    `predict_fn` may return one array or a tuple of arrays.
    """

    def __init__(self, predict_fn: Callable, *, max_batch: int = 32,
                 max_wait_ms: float = 5.0, join_timeout_s: float = 30.0):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._predict = predict_fn
        self._max_batch = max_batch
        self._max_wait_s = max_wait_ms / 1e3
        self._join_timeout_s = join_timeout_s
        self._queue: queue.Queue = queue.Queue()
        self._closed = False
        # orders submit() vs close(): the shutdown sentinel must be the
        # LAST item enqueued, or a request racing past the _closed check
        # could land behind it and its Future would never resolve.
        self._lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="rgp-serving-batcher")
        self._worker.start()
        # observability
        self.calls = 0
        self.requests = 0

    # ------------------------------------------------------------- client

    def submit(self, *arrays: np.ndarray) -> Future:
        """Enqueue one clip. Returns a Future of its (unbatched) result."""
        fut: Future = Future()
        item = (tuple(np.asarray(a) for a in arrays), fut)
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._queue.put(item)
        return fut

    def predict(self, *arrays: np.ndarray, timeout: Optional[float] = None):
        """Blocking convenience wrapper around `submit`."""
        return self.submit(*arrays).result(timeout=timeout)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)  # guaranteed last item (see _lock)
        self._worker.join(timeout=self._join_timeout_s)
        if self._worker.is_alive():
            # A slow predict_fn outlived the join timeout. The worker is
            # still draining the queue and will exit at the sentinel —
            # draining here would steal that sentinel (deadlocking the
            # worker) and fail requests it would have served.
            return
        # Defensive drain: if the worker died (predict_fn crash beyond
        # _dispatch's handler) items could remain; fail their futures
        # instead of letting result() block forever.
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item[1].done():
                item[1].set_exception(RuntimeError("batcher closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- worker

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            batch = [item]
            deadline = time.monotonic() + self._max_wait_s
            while len(batch) < self._max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._dispatch(batch)
                    return
                batch.append(nxt)
            self._dispatch(batch)

    def _dispatch(self, batch: Sequence) -> None:
        # Claim every request up front: set_running_or_notify_cancel()
        # returns False for a Future the caller already cancelled (e.g.
        # after a result() timeout) and atomically blocks cancel() for the
        # rest — so a cancelled request is dropped instead of making
        # set_result raise InvalidStateError mid-loop, which would fail
        # every co-batched neighbour after it.
        batch = [(arrs, fut) for arrs, fut in batch
                 if fut.set_running_or_notify_cancel()]
        if not batch:
            return
        try:
            n = len(batch)
            bucket = _bucket(n, self._max_batch)
            n_args = len(batch[0][0])
            stacked = []
            for i in range(n_args):
                arr = np.stack([arrs[i] for arrs, _ in batch], axis=0)
                if bucket > n:  # zero-pad to the compile bucket
                    pad = np.zeros((bucket - n,) + arr.shape[1:], arr.dtype)
                    arr = np.concatenate([arr, pad], axis=0)
                stacked.append(arr)

            outputs = self._predict(*stacked)
            self.calls += 1
            self.requests += n

            multi = isinstance(outputs, (tuple, list))
            outs = tuple(np.asarray(o) for o in
                         (outputs if multi else (outputs,)))
            for idx, (_, fut) in enumerate(batch):
                piece = tuple(o[idx] for o in outs)
                fut.set_result(piece if multi else piece[0])
        except Exception as exc:  # deliver the failure to every caller
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(exc)
