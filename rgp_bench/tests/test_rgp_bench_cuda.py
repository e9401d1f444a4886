"""Each cell for 2 s on the card, through the benchmark's command (a process of
its own, from the repository's root), untraced and traced: exit 0, `correct`,
and every metric the cell reports. Skips without a card."""

import json
import subprocess

import pytest

from conftest import REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_cell_runs_on_the_card(workload, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [*SPEC["command"], "--workload", workload, "--seed",
         str(2**31 + 211), "--seconds", "2", "--trace", str(trace)],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["count"] == 1
    metrics = SPEC["per_layer"] if trace else SPEC["end_to_end"]
    want = {m["name"] for m in metrics
            if workload in m.get("workloads", [workload])}
    assert set(result["metrics"]) == want
    for name, m in result["metrics"].items():
        assert m["value"] > 0, name
        if m["unit"] == "%":
            assert m["value"] <= 100.0, name
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert result["breakdown"]["device_ops"]
