"""The traced window: `torch.profiler` over host and device, reduced to the
numbers the per-layer readers and the result's `device` and `breakdown`
take.

The arithmetic of `summarize` is `chip_smoke.trace_summary`'s: the device
is busy where the union of its operations' intervals lies, idle elsewhere
in the traced span.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Optional

import numpy as np
import torch

# the traced window that follows the measured one in a `--trace 1` run
TRACE_SECONDS = 3.0
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10
NAME_CHARS = 160


class Trace:
    """Start with `start()`, end with `stop()` after the device has
    finished; then `summary` holds the reduction."""

    def __init__(self):
        self.prof = None
        self.summary: Optional[dict] = None

    def start(self) -> None:
        self.prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()

    def stop(self) -> dict:
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        self.summary = summarize(events)
        return self.summary


def _union(intervals: np.ndarray) -> np.ndarray:
    """Sorted disjoint [start, end) rows covering the given rows."""
    if len(intervals) == 0:
        return intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    last = np.append(np.flatnonzero(new)[1:] - 1, len(iv) - 1)
    return np.stack([starts, ends[last]], 1)


def summarize(events: list) -> dict:
    """From chrome-trace events (microseconds): the span of the trace, the
    device's busy time (any operation: kernel, copy or fill) and its
    kernel-busy time (unions of intervals), device time by operation name,
    copies by direction, and the idle gaps labelled by the innermost host
    event that covers each gap's midpoint ("no host event" where none
    does)."""
    timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
    if not timed:
        raise RuntimeError("the trace holds no timed events")
    t0 = min(float(e["ts"]) for e in timed)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in timed)
    dev = [e for e in timed if e.get("cat") in DEVICE_CATS]
    kern = np.array([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in dev if e["cat"] == "kernel"]).reshape(-1, 2)
    allop = np.array([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                      for e in dev]).reshape(-1, 2)
    busy = _union(allop)
    kbusy = _union(kern)
    by_name: dict = {}
    for e in dev:
        name = e["name"][:NAME_CHARS]
        by_name[name] = by_name.get(name, 0.0) + float(e["dur"]) * 1e-6

    # idle gaps between device operations, inside the span
    edges = np.concatenate([[t0], busy.reshape(-1), [t1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    labels = np.full(len(gaps), -1)
    names: list = []
    if len(gaps):
        mids = (gaps[:, 0] + gaps[:, 1]) / 2
        host = sorted((e for e in timed if e.get("cat") in HOST_CATS),
                      key=lambda e: -float(e["dur"]))
        index: dict = {}
        for e in host:  # longest first, so the innermost paints last
            lo = np.searchsorted(mids, float(e["ts"]), "left")
            hi = np.searchsorted(mids, float(e["ts"]) + float(e["dur"]),
                                 "left")  # [start, end)
            if hi > lo:
                name = e["name"][:NAME_CHARS]
                labels[lo:hi] = index.setdefault(name, len(index))
        names = list(index)
    idle: dict = {}
    for (a, b), k in zip(gaps, labels):
        label = names[k] if k >= 0 else "no host event"
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-6
    copies = {"HtoD": 0.0, "DtoH": 0.0}
    for e in dev:
        for way in copies:
            if e["cat"] == "gpu_memcpy" and way in e["name"]:
                copies[way] += float(e["dur"]) * 1e-6
    return {
        "window_s": (t1 - t0) * 1e-6,
        "busy_s": float((busy[:, 1] - busy[:, 0]).sum()) * 1e-6,
        "kernel_busy_s": float((kbusy[:, 1] - kbusy[:, 0]).sum()) * 1e-6,
        "device_s": by_name,
        "copy_s": copies,
        "breakdown": {
            "device_ops": [[n, s] for n, s in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:TOP]],
            "idle_gaps": [[n, s] for n, s in sorted(
                idle.items(), key=lambda kv: -kv[1])[:TOP]],
        },
    }


def kernel_seconds(summary: dict, patterns: tuple) -> float:
    """Device time of the operations whose names hold any of
    `patterns`."""
    return sum(s for name, s in summary["device_s"].items()
               if any(p in name for p in patterns))
