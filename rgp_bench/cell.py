"""A cell (one configuration under one traffic mix) and what one run of it
yields, found by name from `BENCHMARK.json` under a root directory."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path
from typing import Optional


@dataclasses.dataclass
class Cell:
    root: Path
    spec: dict          # BENCHMARK.json
    workload: dict      # its entry in `workloads`
    config: dict        # the configuration's file
    traffic: dict       # rgp_bench/traffic/<traffic>.json
    limits: dict        # rgp_bench/limits/<workload>.json

    @property
    def name(self) -> str:
        return self.workload["name"]

    def end_to_end(self) -> list:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.spec["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> list:
        """The per-layer metrics this cell reports: those that list it, and
        those that list no cells and move one of its end-to-end
        metrics."""
        mine = {m["name"] for m in self.end_to_end()}
        return [m for m in self.spec["per_layer"]
                if self.name in m.get("workloads", [])
                or ("workloads" not in m and m["moves"] in mine)]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, workload: str) -> Cell:
    root = Path(root)
    spec = load_json(root / "BENCHMARK.json")
    (entry,) = [w for w in spec["workloads"] if w["name"] == workload] or [
        None]
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    (config,) = [c for c in spec["configs"] if c["name"] == entry["config"]]
    bench = root / "rgp_bench"
    return Cell(root=root, spec=spec, workload=entry,
                config=load_json(root / config["file"]),
                traffic=load_json(bench / "traffic" / f"{entry['traffic']}"
                                  ".json"),
                limits=load_json(bench / "limits" / f"{workload}.json"))


def load_module(path: Path, name: str):
    """A module from a file under the root (traffic generators, metric
    readers), so a file dropped into `rgp_bench/` is found by its name
    alone."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def generator(cell: Cell):
    name = cell.traffic["generator"]
    return load_module(cell.root / "rgp_bench" / "generators" / f"{name}.py",
                       f"rgp_bench_generator_{name}")


def reader(cell: Cell, metric: str):
    path = cell.root / "rgp_bench" / "metrics" / f"{metric}.py"
    return load_module(path, "rgp_bench_metric_" + re.sub(r"\W", "_",
                                                           metric))


@dataclasses.dataclass
class Outcome:
    """What a traffic generator's run yields. `units` are requests or steps;
    `readings` the numbers `correct` compares, by name."""

    attempted: int
    failed: int
    end_to_end: dict
    readings: dict
    memory_peak_bytes: int
    window_start: float   # time.perf_counter() when the window opened
    context: "Context"
    notes: dict = dataclasses.field(default_factory=dict)  # not judged


@dataclasses.dataclass
class Context:
    """What the per-layer readers read. `window_s` and `units` are the
    measured (untraced) window's; `trace` is `profile.summarize`'s
    reduction of the traced window, `trace_units` the requests or steps
    that ran in it (None without `--trace 1`)."""

    cell: Cell
    window_s: float
    units: int
    shapes: dict
    spans: dict
    trace: Optional[dict] = None
    trace_units: int = 0
