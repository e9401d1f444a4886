"""The port's ground rules: it imports neither jax nor the JAX package, and
its entry points never carry on quietly on the CPU when the card is
missing."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import recurrent_gaze_prediction_tpu_torch as port

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(port.__file__).resolve().parent


def test_importing_every_port_module_pulls_in_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import recurrent_gaze_prediction_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' "
        "or k.startswith('jax.') or k == 'recurrent_gaze_prediction_tpu' "
        "or k.startswith('recurrent_gaze_prediction_tpu.'))\n"
        "assert len(names) >= 20, names\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_no_source_imports_jax_or_the_jax_package():
    # `recurrent_gaze_prediction_tpu\b` does not match the port's own name:
    # the `_` after `tpu` is a word character, so there is no boundary
    pattern = re.compile(
        r"^\s*(?:from|import)\s+(?:jax\b|recurrent_gaze_prediction_tpu\b)",
        re.MULTILINE)
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 20
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []
    assert pattern.search("from recurrent_gaze_prediction_tpu.ops import x")
    assert not pattern.search("from recurrent_gaze_prediction_tpu_torch import x")


def test_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from recurrent_gaze_prediction_tpu_torch import registry
    from recurrent_gaze_prediction_tpu_torch.cli import serve
    from recurrent_gaze_prediction_tpu_torch.ops.kernels.parity import (
        convgru_parity)
    from recurrent_gaze_prediction_tpu_torch.serving import (
        save_bundle, server_from_bundle)

    with pytest.raises(RuntimeError, match="cuda"):
        registry.create_model("gaze_grcn")
    with pytest.raises(RuntimeError, match="cuda"):
        registry.create_model("gaze_grcn", device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        convgru_parity(t=1, b=1, c=8, units=16)
    model = registry.create_model("gaze_grcn", device="cpu", dim_feature=16,
                                  dim_cnn_proj=8, rnn_state_size=8)
    save_bundle(str(tmp_path), model)
    with pytest.raises(RuntimeError, match="cuda"):
        server_from_bundle(str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--bundle", str(tmp_path), "--port", "0"])
