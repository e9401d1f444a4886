"""Profiling hooks: the port's counterpart of the JAX package's
`train/profiler.py`, on `torch.profiler`.

  * `trace(log_dir)` / `start_trace(log_dir)`: record host and device
    activity (CUDA where the process sees a card) and write a
    TensorBoard-viewable trace (`*.pt.trace.json`) into `log_dir`
  * `span(name, request=None)`: a labelled range of the program, and
    `count(name, n)`: a counter. Both are on only while a torch profiler
    records (this module's, `fit`'s `--profile_steps` window, or any other
    in the process); off, a span is one shared no-op context manager.
  * `records()`, `counts()`, `dropped()`, `clear()`: what spans and
    counters recorded, in memory
  * `profile_steps(...)`: exactly N calls of a step function in a trace

An open span lies in the trace as a `user_annotation` range (as one of
`torch.profiler.record_function` does), and adds one record to a buffer
of at most `CAP` records (later ones are dropped and counted):

    {"name", "start_ns", "end_ns",   # time.time_ns(), the trace's clock:
                                     # a chrome trace's `ts` (us) plus its
                                     # `baseTimeNanoseconds` / 1000
     "id", "parent",                 # the innermost recorded span open on
                                     # the same thread when it opened
     "request",                      # the unit of work; a child inherits
                                     # its parent's when not given
     "thread",                       # threading.get_native_id()
     "counts"}                       # `count`s made while it was open

A span that was open when the profiler started is not recorded: a
recorded span with no parent that is not a unit's root (`train.step`,
`serve.predict`) opened inside one that the window cut.

The gate is the flag that every torch profiler sets for the whole process
while it records; `torch.autograd._profiler_enabled()` is per thread, and
false on the prefetch worker's. The worker's spans are recorded either
way, and lie in the trace only under a profiler started with
`_ExperimentalConfig(profile_all_threads=True)`.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Callable, Iterator

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import (ProfilerActivity, profile,
                            tensorboard_trace_handler)
from torch.utils._pytree import tree_leaves

from ..utils import log

CAP = 1 << 20   # records kept; the rest are dropped and counted

# A user range opened and closed by one C call each, which keep the GIL:
# `record_function`'s operator releases it, so a clock read after it can
# wait for another thread's turn (up to the 5 ms switch interval behind
# the trace's stamp on the card, under the prefetch worker).
_range_enter = torch._C._autograd._record_function_with_args_enter
_range_exit = torch._C._autograd._record_function_with_args_exit

_records: list = []
_counts: dict = {}
_dropped = 0
_lock = threading.Lock()
_ids = itertools.count(1)
# .open: the recorded spans open on a thread, innermost last
_local = threading.local()


def enabled() -> bool:
    """True while any torch profiler in the process records."""
    return _autograd_profiler._is_profiler_enabled


class _Off:
    """The span while no profiler records: nothing is recorded."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def _open_spans() -> list:
    stack = getattr(_local, "open", None)
    if stack is None:
        stack = _local.open = []
    return stack


class _Span:
    __slots__ = ("record", "handle")

    def __init__(self, name: str, request):
        self.record = {"name": name, "start_ns": 0, "end_ns": 0,
                       "id": next(_ids), "parent": None, "request": request,
                       "thread": threading.get_native_id(), "counts": None}

    def __enter__(self):
        rec = self.record
        stack = _open_spans()
        if stack:
            parent = stack[-1]
            rec["parent"] = parent["id"]
            if rec["request"] is None:
                rec["request"] = parent["request"]
        stack.append(rec)
        self.handle = _range_enter(rec["name"])
        rec["start_ns"] = time.time_ns()   # a few us after the range's stamp
        return rec

    def __exit__(self, *exc) -> bool:
        _range_exit(self.handle)
        rec = self.record
        rec["end_ns"] = time.time_ns()
        _open_spans().pop()
        global _dropped
        with _lock:
            if len(_records) < CAP:
                _records.append(rec)
            else:
                _dropped += 1
        return False


def span(name: str, request=None):
    """`with span(name[, request]):` a labelled range of the program
    (see the module's docstring); a no-op while no profiler records."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, request)


def count(name: str, n) -> None:
    """Add `n` to the counter `name` while a profiler records, and to the
    innermost recorded span open on this thread (also once the profiler
    has stopped: the span was recorded)."""
    stack = getattr(_local, "open", None)
    if stack:
        counts = stack[-1]["counts"]
        if counts is None:
            counts = stack[-1]["counts"] = {}
        counts[name] = counts.get(name, 0) + n
    if _autograd_profiler._is_profiler_enabled:
        with _lock:
            _counts[name] = _counts.get(name, 0) + n


def records() -> list:
    """A copy of the recorded spans, in the order they closed."""
    with _lock:
        return [dict(r) for r in _records]


def counts() -> dict:
    """The counters' totals."""
    with _lock:
        return dict(_counts)


def dropped() -> int:
    """Spans not recorded because the buffer held `CAP` records."""
    return _dropped


def clear() -> None:
    """Empty the buffer and the counters."""
    global _dropped
    with _lock:
        _records.clear()
        _counts.clear()
        _dropped = 0


# A process's first range is slow, part of it after the trace's stamp:
# paid here, where no profiler records, a recorded span's first record
# lies as close to its range as the rest.
if not enabled():
    _range_exit(_range_enter("profiler.warm_up"))


def start_trace(log_dir: str) -> profile:
    """Start recording, with the span buffer cleared; `stop()` on the
    returned profiler writes the trace into `log_dir`."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log.info("capturing torch profiler trace into %s", log_dir)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(log_dir))
    clear()
    prof.start()
    return prof


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    prof = start_trace(log_dir)
    try:
        yield prof
    finally:
        prof.stop()


def _sync_outputs(out) -> None:
    """Wait for the devices that hold any tensor of `out`."""
    for device in {x.device for x in tree_leaves(out)
                   if isinstance(x, torch.Tensor) and x.is_cuda}:
        torch.cuda.synchronize(device)


def profile_steps(step_fn: Callable, inputs, n_steps: int,
                  log_dir: str) -> profile:
    """Run `step_fn(*inputs)` n_steps times in a trace, each step labelled
    `step_<i>`; the device finishes the last step's outputs before the
    trace closes. Returns the stopped profiler (`key_averages()`,
    `events()`)."""
    with trace(log_dir) as prof:
        out = None
        for i in range(n_steps):
            with span(f"step_{i}"):
                out = step_fn(*inputs)
        _sync_outputs(out)
    return prof
