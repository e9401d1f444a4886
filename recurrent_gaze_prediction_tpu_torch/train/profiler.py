"""Profiling hooks: the port's counterpart of the JAX package's
`train/profiler.py`, on `torch.profiler`.

  * `trace(log_dir)`: a context manager that records host and device
    activity (CUDA where the process sees a card) and writes a
    TensorBoard-viewable trace (`*.pt.trace.json`) into `log_dir`
  * `annotate(name)`: a labelled range in the trace
    (`torch.profiler.record_function`)
  * `profile_steps(...)`: exactly N calls of a step function in a trace
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator

import torch
from torch.profiler import (ProfilerActivity, profile, record_function,
                            tensorboard_trace_handler)
from torch.utils._pytree import tree_leaves

from ..utils import log


def start_trace(log_dir: str) -> profile:
    """Start recording; `stop()` on the returned profiler writes the trace
    into `log_dir`."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log.info("capturing torch profiler trace into %s", log_dir)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(log_dir))
    prof.start()
    return prof


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    prof = start_trace(log_dir)
    try:
        yield prof
    finally:
        prof.stop()


def annotate(name: str):
    return record_function(name)


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
            with annotate(f"step_{i}"):
                out = step_fn(*inputs)
        _sync_outputs(out)
    return prof
