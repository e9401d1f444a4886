"""Fixtures of the benchmark's tests: a copy of the benchmark's files under
a temporary root, with the configurations and traffic cut to a size the
CPU runs in seconds (the program then runs its kernels' plain versions)."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_MODEL = {"n_lstm_steps": 4, "dim_feature": 1024, "dim_cnn_proj": 16,
              "rnn_state_size": 16}
# conv5b keeps its 512 channels: the pipeline folds them to 1024
TINY_TOWER = [8, 8, 16, 16, 16, 16, 16, 512]
TINY_TRAFFIC = {
    "video": {"batch": 2, "frames": 32, "pool_batches": 2, "callers": 2,
              "calib_windows": 2, "warmup_requests": 1,
              "reference_rows": 2},
    "train": {"batch": 4, "clips": 12, "warmup_steps": 1, "log_every": 2},
}


def copy_benchmark(dest: Path) -> Path:
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(REPO / "rgp_bench", dest / "rgp_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dest


def shrink(root: Path) -> Path:
    bench = root / "rgp_bench"
    for path in (bench / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["model"].update(TINY_MODEL)
        cfg["c3d"]["channels"] = TINY_TOWER
        path.write_text(json.dumps(cfg))
    for path in (bench / "traffic").glob("*.json"):
        tr = json.loads(path.read_text())
        kind = "video" if tr["generator"] == "video_closed_loop" else "train"
        tr.update(TINY_TRAFFIC[kind])
        path.write_text(json.dumps(tr))
    return root


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return shrink(copy_benchmark(tmp_path))
