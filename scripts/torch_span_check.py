"""The port's spans and counters on the card: each record against its
range in the profiler's trace, the traced window's rate, and what a span
costs off and on.

    python3 scripts/torch_span_check.py [--workloads a,b] [--seed N] \
        [--seconds S] [--spans N] [--root DIR --device cpu]

For each benchmark cell (`BENCHMARK.json`; default all) it runs the
cell's traffic generator once with its traced window (`rgp_bench`, a
short untimed window of `--seconds` first), keeps that window's chrome
trace, and prints one JSON line: the records by name (count, mean ms),
the largest distance in us of a record from the `user_annotation` range
of the same name on the same thread, the records on threads the profiler
did not trace (the prefetch worker, the callers' threads), the window's
units (steps or requests) per second, the per-layer metrics that read
the records, and the idle time under no host event against all idle
time. Then one line with a span's cost in us: off (no profiler), and on
under a recording profiler of host and device. Needs a CUDA card; `--root`
(a copy of the benchmark's files with smaller configurations) and
`--device cpu` rehearse it on the CPU.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from recurrent_gaze_prediction_tpu_torch.train import profiler  # noqa: E402
from rgp_bench import cell as cells  # noqa: E402
from rgp_bench import profile, spans  # noqa: E402

SPAN_METRICS = ("step_host_ms.train", "forward_host_ms.train",
                "backward_host_ms.train", "optimizer_host_ms.train",
                "prefetch_wait_ms.train", "input_mb_per_step.train",
                "upload_host_ms.video", "h2d_ms.video",
                "input_wait_ms.train", "device_idle.train",
                "device_idle.video")
KEPT: list = []


class KeptTrace(profile.Trace):
    """The benchmark's traced window, keeping the whole exported trace."""

    def stop(self) -> dict:
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                KEPT.append(json.load(f))
        finally:
            os.unlink(path)
        self.prof = None
        self.summary = profile.summarize(KEPT[-1]["traceEvents"])
        return self.summary


def clock_gaps(records: list, trace: dict) -> dict:
    """Each record's larger distance (start or end) from the nearest range
    of its name on its thread, us; records on untraced threads apart."""
    base_us = float(trace.get("baseTimeNanoseconds", 0)) / 1e3
    ranges: dict = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation" and "dur" in e:
            ranges.setdefault((e["name"], int(e["tid"])), []).append(
                (float(e["ts"]) + base_us, float(e["dur"])))
    traced = {tid for _, tid in ranges}
    for rows in ranges.values():
        rows.sort()
    gaps, untraced = [], {}
    for r in records:
        rows = ranges.get((r["name"], r["thread"]))
        if not rows:
            key = r["name"] if r["thread"] not in traced else \
                f"{r['name']} (no range)"
            untraced[key] = untraced.get(key, 0) + 1
            continue
        start = r["start_ns"] / 1e3
        i = bisect.bisect_left(rows, (start, 0.0))
        near = min(rows[max(i - 1, 0):i + 1],
                   key=lambda row: abs(row[0] - start))
        gaps.append(max(abs(start - near[0]),
                        abs(r["end_ns"] / 1e3 - near[0] - near[1])))
    gaps.sort()
    return {"compared": len(gaps), "max_us": gaps[-1] if gaps else None,
            "p99_us": gaps[int(0.99 * (len(gaps) - 1))] if gaps else None,
            "over_100us": sum(g > 100.0 for g in gaps),
            "untraced": untraced}


def unlabeled(trace: dict, top: int = 8) -> list:
    """The idle gaps under no host event (as `rgp_bench.profile` labels
    them), by the host events on either side of each gap's midpoint: the
    last to end before it and the first to start after it, on any
    thread -> [[before, after, seconds, gaps]], the largest first."""
    events = [e for e in trace["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in events if e.get("cat") in profile.DEVICE_CATS)
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in events if e.get("cat") in profile.HOST_CATS]
    covered = profile._union(np.array([h[:2] for h in host]).reshape(-1, 2))
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    gaps, end = [], t0
    for a, b in dev + [(t1, t1)]:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    by_end = sorted(host, key=lambda h: h[1])
    ends = [h[1] for h in by_end]
    by_start = sorted(host)
    starts = [h[0] for h in by_start]
    out: dict = {}
    for a, b in gaps:
        mid = (a + b) / 2
        k = np.searchsorted(covered[:, 0], mid, "right") - 1
        if k >= 0 and mid < covered[k, 1]:
            continue
        i = bisect.bisect_right(ends, mid) - 1
        j = bisect.bisect_right(starts, mid)
        key = (by_end[i][2][:60] if i >= 0 else "",
               by_start[j][2][:60] if j < len(by_start) else "")
        sec, n = out.get(key, (0.0, 0))
        out[key] = (sec + (b - a) * 1e-6, n + 1)
    return [[k[0], k[1], sec, n] for k, (sec, n) in sorted(
        out.items(), key=lambda kv: -kv[1][0])[:top]]


def by_name(records: list) -> dict:
    out: dict = {}
    for r in records:
        n, total = out.get(r["name"], (0, 0.0))
        out[r["name"]] = (n + 1, total + spans.ms(r))
    return {k: {"count": n, "mean_ms": total / n}
            for k, (n, total) in sorted(out.items())}


def check_cell(root: Path, name: str, seed: int, seconds: float,
               device) -> dict:
    cell = cells.load_cell(root, name)
    profiler.clear()
    outcome = cells.generator(cell).run(cell, seed, seconds, True, device)
    ctx = outcome.context
    records = profiler.records()
    idle = ctx.trace["window_s"] - ctx.trace["busy_s"]
    gaps = dict(ctx.trace["breakdown"]["idle_gaps"])
    metrics = {}
    for m in cell.per_layer():
        if m["name"] in SPAN_METRICS:
            metrics[m["name"]] = cells.reader(cell, m["name"]).read(ctx)
    return {"workload": name, "seed": seed,
            "trace_units": ctx.trace_units,
            "window_s": ctx.trace["window_s"],
            "units_per_s": ctx.trace_units / ctx.trace["window_s"],
            "idle_s": idle,
            "no_host_event_idle_s": gaps.get("no host event", 0.0),
            "idle_gaps": ctx.trace["breakdown"]["idle_gaps"],
            "metrics": metrics, "records": by_name(records),
            "clock": clock_gaps(records, KEPT[-1]),
            "unlabeled": unlabeled(KEPT[-1]),
            "dropped": profiler.dropped(),
            "correct_readings": outcome.readings}


def span_cost(n_off: int, n_on: int) -> dict:
    """us per `with span(...)`: off, and on under a profiler of host and
    device (records cleared before and after)."""
    profiler.clear()
    loops = {}
    start = time.perf_counter()
    for _ in range(n_off):
        with profiler.span("cost.off"):
            pass
    loops["off_us"] = (time.perf_counter() - start) / n_off * 1e6
    start = time.perf_counter()
    for _ in range(n_off):
        pass
    loops["empty_loop_us"] = (time.perf_counter() - start) / n_off * 1e6
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        start = time.perf_counter()
        for _ in range(n_on):
            with profiler.span("cost.on"):
                pass
        loops["on_us"] = (time.perf_counter() - start) / n_on * 1e6
    loops["records"] = len(profiler.records())
    profiler.clear()
    return loops


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workloads", default="")
    parser.add_argument("--seed", type=int, default=2147489001)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--spans", type=int, default=200000)
    parser.add_argument("--root", type=Path, default=ROOT)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("torch_span_check: no CUDA card", file=sys.stderr)
        return 2
    profile.Trace = KeptTrace   # the generators load it by name
    spec = json.loads((args.root / "BENCHMARK.json").read_text())
    names = [w for w in args.workloads.split(",") if w] or [
        w["name"] for w in spec["workloads"]]
    for k, name in enumerate(names):
        print(json.dumps(check_cell(args.root, name, args.seed + k,
                                    args.seconds, device)), flush=True)
    print(json.dumps({"span_cost": span_cost(args.spans, args.spans // 50),
                      "device": (torch.cuda.get_device_name(device)
                                 if device.type == "cuda" else "cpu"),
                      "torch": torch.__version__}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
