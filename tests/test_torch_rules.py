"""The port's ground rules: it imports neither jax nor the JAX package, its
entry points never carry on quietly on the CPU when the card is missing,
and its imports of the recurrence kernels point one way: the models reach
them through the route module only, and the ConvGRU kernel modules import
one another at module level."""

import ast
import os
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


def _relative_imports(node: ast.AST, package: list[str],
                      level: int = 0) -> list[str]:
    """The dotted names a node's relative imports bring in (module path and
    imported name), resolved against `package`, the importing module's
    package path; only imports of relative level `level` when it is
    given."""
    names = []
    for n in ast.walk(node):
        if isinstance(n, ast.ImportFrom) and n.level and level in (0,
                                                                   n.level):
            mod = package[:len(package) - n.level + 1] + (
                n.module.split(".") if n.module else [])
            names += [".".join(mod + [a.name]) for a in n.names]
    return names


def test_models_reach_the_kernels_through_the_route_module_only():
    """No module under `models/` imports an `ops/kernels` module other than
    the route module and the int8 tower's `conv3d_int8`."""
    allowed = ("ops.kernels.route.", "ops.kernels.conv3d_int8.")
    kernels, offenders = [], []
    for f in sorted((PKG / "models").glob("*.py")):
        for name in _relative_imports(ast.parse(f.read_text()), ["models"]):
            if name.startswith("ops.kernels."):
                kernels.append(name)
                if not name.startswith(allowed):
                    offenders.append(f"{f.name} -> {name}")
    assert kernels and offenders == []


def test_convgru_kernel_modules_import_no_sibling_inside_a_function():
    """No function in `ops/kernels/convgru*.py` imports a sibling module:
    their imports point one way, at module level."""
    files = sorted((PKG / "ops" / "kernels").glob("convgru*.py"))
    assert len(files) >= 4
    offenders = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                offenders += [f"{f.name}:{node.name} -> {name}" for name in
                              _relative_imports(node, ["ops", "kernels"],
                                                level=1)]
    assert offenders == []


def test_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from recurrent_gaze_prediction_tpu_torch import registry
    from recurrent_gaze_prediction_tpu_torch.cli import serve
    from recurrent_gaze_prediction_tpu_torch.models import streaming
    from recurrent_gaze_prediction_tpu_torch.ops.kernels.parity import (
        convgru_parity, convlstm_parity)
    from recurrent_gaze_prediction_tpu_torch.serving import (
        save_bundle, server_from_bundle)

    with pytest.raises(RuntimeError, match="cuda"):
        registry.create_model("gaze_grcn")
    with pytest.raises(RuntimeError, match="cuda"):
        registry.create_model("gaze_grcn", device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        registry.create_model("gaze_lstm")
    with pytest.raises(RuntimeError, match="cuda"):
        convgru_parity(t=1, b=1, c=8, units=16)
    with pytest.raises(RuntimeError, match="cuda"):
        convlstm_parity(t=1, b=1, c=8, units=16)
    model = registry.create_model("gaze_grcn", device="cpu", dim_feature=16,
                                  dim_cnn_proj=8, rnn_state_size=8)
    save_bundle(str(tmp_path), model)
    with pytest.raises(RuntimeError, match="cuda"):
        server_from_bundle(str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--bundle", str(tmp_path), "--port", "0"])
    for init in (streaming.init_stream_state,
                 streaming.init_lstm_stream_state):
        with pytest.raises(RuntimeError, match="cuda"):
            init(1, model.cfg)


def test_evaluation_and_prefetch_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from recurrent_gaze_prediction_tpu_torch.cli import evaluate_gaze
    from recurrent_gaze_prediction_tpu_torch.config import ExperimentConfig
    from recurrent_gaze_prediction_tpu_torch.data import synthetic
    from recurrent_gaze_prediction_tpu_torch.data.prefetch import (
        prefetch_batches)
    from recurrent_gaze_prediction_tpu_torch.eval import evaluator

    data = synthetic.make_clip_windows(2, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        prefetch_batches(data, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        evaluator.generate(lambda f, c: c, data, 2)
    ExperimentConfig().dump(str(tmp_path / "config.json"))
    with pytest.raises(RuntimeError, match="cuda"):
        evaluate_gaze.main(["--train_dir", str(tmp_path)])


def test_raw_video_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from recurrent_gaze_prediction_tpu_torch import registry
    from recurrent_gaze_prediction_tpu_torch.cli import train_fused
    from recurrent_gaze_prediction_tpu_torch.models import c3d
    from recurrent_gaze_prediction_tpu_torch.serving import (
        save_bundle, server_from_bundle)

    with pytest.raises(RuntimeError, match="cuda"):
        train_fused.main(["--dataset", "synthetic", "--max_steps", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        c3d.init_params()
    model = registry.create_model("gaze_grcn", device="cpu", dim_feature=1024,
                                  dim_cnn_proj=8, rnn_state_size=8)
    tower = {k: v[:1] for k, v in c3d.init_params(device="cpu").items()}
    save_bundle(str(tmp_path), model, c3d_params=tower, num_frames=16)
    with pytest.raises(RuntimeError, match="cuda"):
        server_from_bundle(str(tmp_path), program="fused")


def test_zoo_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from recurrent_gaze_prediction_tpu_torch import registry
    from recurrent_gaze_prediction_tpu_torch.cli import pretrain_shallownet
    from recurrent_gaze_prediction_tpu_torch.train.saliency import (
        fit_shallownet)

    for name in ("gaze_rnn", "gaze_c3d_conv", "gaze_framewise_shallownet",
                 "gaze_grcn_cascade", "gaze_pupil_grcn", "gaze_pupil_gru2"):
        with pytest.raises(RuntimeError, match="cuda"):
            registry.create_model(name)
    with pytest.raises(RuntimeError, match="cuda"):
        pretrain_shallownet.main(["--out", str(tmp_path / "sn.pt")])
    with pytest.raises(RuntimeError, match="cuda"):
        fit_shallownet(pretrain_shallownet.SyntheticSaliency(n=16),
                       max_steps=1)
    assert not (tmp_path / "sn.pt").exists()


def test_research_loop_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    import numpy as np

    from recurrent_gaze_prediction_tpu_torch.action import (ActionClassifier,
                                                            ActionHParams)
    from recurrent_gaze_prediction_tpu_torch.action import classification
    from recurrent_gaze_prediction_tpu_torch.cli import (
        action_classification, create_records, evaluate_gaze,
        extract_features, extract_map, train_gaze)
    from recurrent_gaze_prediction_tpu_torch.config import ExperimentConfig

    d = str(tmp_path)
    ExperimentConfig().dump(str(tmp_path / "config.json"))
    for main, argv in (
            (extract_features.main, ["--videos", "v.avi", "--out_dir", d]),
            (extract_map.main, ["--train_dir", d, "--clips_root", d,
                                "--out_dir", d]),
            (extract_map.main, ["--train_dir", d, "--clips_root", d,
                                "--out_dir", d, "--streaming"]),
            (create_records.main, ["--train_dir", d, "--out_dir", d]),
            (action_classification.main, ["--records_glob", "x-*.npz"]),
            (train_gaze.main, ["--dataset", "crc", "--data_root", d]),
            (evaluate_gaze.main, ["--train_dir", d, "--dataset",
                                  "hollywood2", "--data_root", d])):
        with pytest.raises(RuntimeError, match="cuda"):
            main(argv)
    with pytest.raises(RuntimeError, match="cuda"):
        ActionClassifier(ActionHParams())
    with pytest.raises(RuntimeError, match="cuda"):
        classification.init_params(ActionHParams())
    with pytest.raises(RuntimeError, match="cuda"):
        extract_features.extract_windows({}, np.zeros((16, 8, 8, 3),
                                                      np.uint8))
    assert not (tmp_path / "model").exists()


def test_workflow_entry_points_raise_without_cuda(tmp_path):
    """The export CLI and the SALICON and video-corpus trainers resolve
    the card before they restore, read or decode anything."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from recurrent_gaze_prediction_tpu_torch.cli import (export_serving,
                                                         pretrain_shallownet,
                                                         train_fused)
    from recurrent_gaze_prediction_tpu_torch.config import ExperimentConfig

    d = str(tmp_path)
    ExperimentConfig().dump(str(tmp_path / "config.json"))
    for main, argv in (
            (export_serving.main, ["--train_dir", d, "--out_dir",
                                   f"{d}/bundle"]),
            (pretrain_shallownet.main, ["--dataset", "salicon",
                                        "--salicon_root", d, "--out",
                                        f"{d}/sn.pt"]),
            (train_fused.main, ["--dataset", "videos", "--videos_root", d,
                                "--gaze_root", d])):
        with pytest.raises(RuntimeError, match="cuda"):
            main(argv)
    assert sorted(os.listdir(d)) == ["config.json"]


def test_research_loop_refusals(tmp_path):
    """A mesh larger than this one-rank world raises the JAX package's
    error before any device is touched; real data needs --data_root.
    `load_frame_folder`'s native backend (ported) reads an empty folder,
    and an unknown backend is refused."""
    from recurrent_gaze_prediction_tpu_torch.cli import (evaluate_gaze,
                                                         extract_map,
                                                         train_gaze)
    from recurrent_gaze_prediction_tpu_torch.config import ExperimentConfig
    from recurrent_gaze_prediction_tpu_torch.data import video

    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices"):
        extract_map.main(["--train_dir", ".", "--clips_root", ".",
                          "--out_dir", ".", "--data_parallel", "2"])
    assert video.load_frame_folder(str(tmp_path), backend="native").shape \
        == (0, 0, 0, 3)
    with pytest.raises(ValueError, match="pil\\|native"):
        video.load_frame_folder(str(tmp_path), backend="opencv")
    assert train_gaze.main(["--dataset", "crc", "--device", "cpu"]) == 1
    ExperimentConfig().dump(str(tmp_path / "config.json"))
    assert evaluate_gaze.main(["--train_dir", str(tmp_path), "--dataset",
                               "crc", "--device", "cpu"]) == 1
