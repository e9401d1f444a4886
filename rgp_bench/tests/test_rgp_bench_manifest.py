"""`BENCHMARK.json` against the benchmark's rules, the files each cell
finds by name, files dropped in without an edit, and the modules a run
loads: never JAX or the JAX package, and the reference nothing of the
program either."""

from __future__ import annotations

import ast
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path


from conftest import REPO, TINY_TRAFFIC, copy_benchmark, shrink

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$"
UNIT = r"^[A-Za-z0-9_/%.\-]{1,16}$"
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
JAX_NAMES = {"jax", "jaxlib", "flax", "recurrent_gaze_prediction_tpu"}


def _names():
    yield from (c["name"] for c in SPEC["configs"])
    for w in SPEC["workloads"]:
        yield from (w["name"], w["config"], w["traffic"])
    yield from (m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"])
    for c in SPEC["configs"]:
        yield from c["reduced"]


def test_keys_names_and_units():
    import re

    assert set(SPEC) == KEYS
    assert SPEC["command"][:2] == ["python3", "-m"] and len(
        SPEC["command"]) <= 32
    assert all(re.match(NAME, n) for n in _names())
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert all(re.match(UNIT, m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for group in ("configs", "workloads"):
        names = [x["name"] for x in SPEC[group]]
        assert len(names) == len(set(names))
    assert len({m["name"] for m in metrics}) == len(metrics)
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(set(c) == {"name", "source", "file", "reduced", "why"}
               for c in SPEC["configs"])
    assert all(len(w["why"]) <= 200 and "\n" not in w["why"]
               for w in SPEC["workloads"])
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_bounds_and_run_length():
    seconds = SPEC["run_seconds"]
    assert isinstance(seconds, int) and 1 <= seconds <= 51
    # a full check of 24 cells, 14 runs each, fits in 43,200 s
    assert (2 + 14 * 24) * (seconds + 60) + 24 * 180 + 1200 <= 43200
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in SPEC["end_to_end"])


def test_every_cell_reports_and_every_metric_moves_what_its_cells_report():
    from rgp_bench.cell import load_cell

    used = set()
    for w in SPEC["workloads"]:
        assert w["chips"] == 1
        cell = load_cell(REPO, w["name"])
        used.add(w["config"])
        e2e = {m["name"] for m in cell.end_to_end()}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer()
        for m in cell.per_layer():
            assert m["moves"] in e2e, (w["name"], m["name"])
    assert used == {c["name"] for c in SPEC["configs"]}
    e2e_names = {m["name"] for m in SPEC["end_to_end"]}
    layers = {}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e_names
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        layers.setdefault(m["layer"], set()).add(m["name"])
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["better"] == "higher"
    perf = (REPO / "PERF.md").read_text()
    for layer in layers:
        assert f"**{layer}**" in perf, layer


def test_each_cell_finds_its_files_by_name():
    from rgp_bench import cell as cells

    for w in SPEC["workloads"]:
        cell = cells.load_cell(REPO, w["name"])
        assert cells.generator(cell).run
        for m in cell.per_layer():
            assert cells.reader(cell, m["name"]).read
        assert cell.limits and all(isinstance(v, float)
                                   for v in cell.limits.values())
    for c in SPEC["configs"]:
        path = REPO / c["file"]
        assert path.is_file() and c["file"].startswith("rgp_bench/")
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"] and cfg["assumed"]


def _sources(directory: Path):
    return [p for p in directory.rglob("*.py") if "tests" not in p.parts]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_imports_jax_and_the_reference_nothing_of_the_program():
    for path in _sources(REPO / "rgp_bench"):
        assert not _imports(path) & JAX_NAMES, path
    allowed = {"__future__", "contextlib", "typing", "math", "torch",
               "numpy"}
    for path in (REPO / "rgp_bench" / "reference").glob("*.py"):
        assert _imports(path) <= allowed, (path, _imports(path))


def test_a_run_loads_no_jax(tmp_path):
    """A tiny cell of each traffic generator on the CPU, in a process of
    its own; the top-level names of the modules it loaded, compared
    whole."""
    root = shrink(copy_benchmark(tmp_path))
    code = textwrap.dedent(f"""
        import json, sys
        from pathlib import Path
        from rgp_bench import run
        for w in ("grcn_int8_video", "grcn_train_b28"):
            r = run.run_cell(Path({str(root)!r}), w, 3, 0.5, False, "cpu")
            assert r["correct"], r
        top = {{m.split(".")[0] for m in sys.modules}}
        print(json.dumps(sorted(top)))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "recurrent_gaze_prediction_tpu_torch" in top
    assert not top & JAX_NAMES


def test_no_card_and_no_program_mean_no_result(tmp_path):
    """Without a CUDA card the command exits non-zero and prints nothing
    on standard output; in a directory holding only the benchmark's files
    the program cannot be imported."""
    import torch

    if not torch.cuda.is_available():
        out = subprocess.run(
            [sys.executable, "-m", "rgp_bench.run", "--workload",
             "grcn_int8_video", "--seed", "1", "--seconds", "1"], cwd=REPO,
            capture_output=True, text=True, timeout=300)
        assert out.returncode != 0 and out.stdout == ""
    bare = copy_benchmark(tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run(
        [sys.executable, "-c", "from pathlib import Path; "
         "from rgp_bench import run; run.run_cell(Path('.'), "
         "'grcn_int8_video', 1, 1.0, False, 'cpu')"],
        cwd=bare, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "recurrent_gaze_prediction_tpu_torch" in out.stderr


def test_dropped_in_files_are_found_without_an_edit(tmp_path):
    """A configuration, a traffic mix, limits and a per-layer metric added
    as files, and entries in BENCHMARK.json, make a cell that runs."""
    from rgp_bench import run

    root = shrink(copy_benchmark(tmp_path))
    bench = root / "rgp_bench"
    cfg = json.loads((bench / "configs" / "gaze_lstm.json").read_text())
    cfg["name"] = "gaze_lstm_copy"
    (bench / "configs" / "gaze_lstm_copy.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "video_int8_b16x2.json")
                         .read_text())
    traffic.update(TINY_TRAFFIC["video"], callers=1)
    (bench / "traffic" / "video_int8_one_caller.json").write_text(
        json.dumps(traffic))
    (bench / "limits" / "lstm_int8_video.json").write_text(
        (bench / "limits" / "grcn_int8_video.json").read_text())
    (bench / "metrics" / "requests.video.py").write_text(
        "def read(ctx):\n    return float(ctx.units)\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "gaze_lstm_copy", "source": "x",
                            "file": "rgp_bench/configs/gaze_lstm_copy.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "lstm_int8_video",
                              "config": "gaze_lstm_copy",
                              "traffic": "video_int8_one_caller",
                              "chips": 1, "why": "x"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in ("video_frames_per_s", "video_request_p95_ms",
                         "mfu.video"):
            m["workloads"].append("lstm_int8_video")
    spec["per_layer"].append({"name": "requests.video", "unit": "1",
                              "better": "higher", "source": "host_clock",
                              "layer": "client",
                              "moves": "video_frames_per_s",
                              "workloads": ["lstm_int8_video"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    result = run.run_cell(root, "lstm_int8_video", 4, 0.5, True, "cpu")
    assert result["correct"], result
    assert result["metrics"]["requests.video"]["value"] >= 1
    assert "mfu.video" in result["metrics"]
    assert math.isfinite(result["checks"]["map_gap"]["value"])
