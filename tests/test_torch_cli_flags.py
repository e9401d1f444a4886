"""Fault C3: every flag of the JAX package's `cli.train_gaze`,
`cli.evaluate_gaze`, `cli.pretrain_shallownet` and `cli.export_serving` is
known to the port's counterpart, so no JAX command line fails there as
"unrecognized arguments", and each parses as in the JAX package.

The mesh flags (`--data_parallel`, `--model_parallel`) are taken by all
four CLIs that have them: in this process (a world of one) a mesh larger
than the world raises the JAX package's ValueError, and a mesh of one
rank trains. Their multi-rank runs: tests/test_torch_parallel.py.
"""

import os

import pytest
import torch
import torch.distributed as dist

from recurrent_gaze_prediction_tpu.cli import evaluate_gaze as jeval
from recurrent_gaze_prediction_tpu.cli import export_serving as jexport
from recurrent_gaze_prediction_tpu.cli import pretrain_shallownet as jpre
from recurrent_gaze_prediction_tpu.cli import train_gaze as jtrain
from recurrent_gaze_prediction_tpu_torch.cli import evaluate_gaze
from recurrent_gaze_prediction_tpu_torch.cli import export_serving
from recurrent_gaze_prediction_tpu_torch.cli import pretrain_shallownet
from recurrent_gaze_prediction_tpu_torch.cli import train_gaze

PAIRS = {
    "train_gaze": (jtrain, train_gaze),
    "evaluate_gaze": (jeval, evaluate_gaze),
    "pretrain_shallownet": (jpre, pretrain_shallownet),
    "export_serving": (jexport, export_serving),
}


@pytest.mark.parametrize("cli", sorted(PAIRS))
def test_port_knows_every_jax_flag(cli):
    jax_cli, port_cli = PAIRS[cli]
    jax_flags = set(jax_cli.build_parser()._option_string_actions)
    port_flags = set(port_cli.build_parser()._option_string_actions)
    assert jax_flags - port_flags == set()


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")


@pytest.mark.parametrize("argv,error", [
    (["--data_parallel", "2"], "mesh 2x1 needs 2 devices, have 1"),
    (["--data_parallel", "-1"], None),
    (["--model_parallel", "2"], "mesh 1x2 needs 2 devices, have 1"),
])
def test_train_gaze_refuses_unported_flags_by_name(argv, error, monkeypatch):
    """The mesh flags are taken: a mesh larger than this one-rank world
    raises the JAX package's error; `--data_parallel -1` trains on a mesh
    of one rank (and leaves no process group behind)."""
    made = []
    real = train_gaze.cli_mesh
    monkeypatch.setattr(train_gaze, "cli_mesh",
                        lambda *a: made.append(a) or real(*a))
    argv = argv + ["--device", "cpu"]
    if error is not None:
        with pytest.raises(ValueError, match=error):
            train_gaze.main(argv)
    else:
        assert train_gaze.main(argv + [
            "--max_steps", "1", "--n_lstm_steps", "2", "--batch_size", "2",
            "--synthetic_clips", "2", "--compute_dtype", "float32",
            "--no_prefetch"]) == 0
    assert len(made) == 1 and made[0][2] == "cpu"
    assert not dist.is_initialized()


@pytest.mark.parametrize("cli,argv", [
    ("train_fused", ["--dataset", "synthetic", "--data_parallel", "2"]),
    ("train_fused", ["--dataset", "synthetic", "--model_parallel", "2"]),
    ("evaluate_gaze", ["--data_parallel", "3"]),
    ("extract_map", ["--clips_root", ".", "--out_dir", ".",
                     "--data_parallel", "2"]),
])
def test_mesh_flags_are_taken_by_every_cli(cli, argv, tmp_path):
    """No CLI exits 2 for the mesh flags: each builds its mesh, which is
    larger than this one-rank world."""
    from recurrent_gaze_prediction_tpu_torch.cli import (extract_map,
                                                         train_fused)
    from recurrent_gaze_prediction_tpu_torch.config import ExperimentConfig

    ExperimentConfig().dump(str(tmp_path / "config.json"))
    module = {"train_fused": train_fused, "evaluate_gaze": evaluate_gaze,
              "extract_map": extract_map}[cli]
    if cli != "train_fused":
        argv = argv + ["--train_dir", str(tmp_path)]
    with pytest.raises(ValueError, match="devices, have 1"):
        module.main(argv + ["--device", "cpu"])
    assert not dist.is_initialized()


@pytest.mark.parametrize("flag,value", [("--pallas", True),
                                        ("--no_pallas", False)])
def test_train_gaze_accepts_the_route_switches(flag, value):
    """Both parse (as the JAX flags do) and change nothing: past the
    refusals, main goes on to resolve the device, which needs a card."""
    args = train_gaze.build_parser().parse_args([flag])
    assert args.use_pallas is value
    assert train_gaze.build_parser().parse_args([]).use_pallas is None
    # the defaults of the refused flags parse and are not refused
    assert (args.profile_steps, args.data_parallel,
            args.model_parallel) == (0, 1, 1)
    _no_card()
    with pytest.raises(RuntimeError, match="cuda"):
        train_gaze.main([flag, "--profile_steps", "0", "--data_parallel",
                         "1", "--model_parallel", "1"])


def test_train_gaze_takes_profile_steps():
    """`--profile_steps N` is no longer refused: main goes on to resolve
    the device (the window itself: tests/test_torch_observability.py)."""
    assert train_gaze.build_parser().parse_args(
        ["--profile_steps", "2"]).profile_steps == 2
    _no_card()
    with pytest.raises(RuntimeError, match="cuda"):
        train_gaze.main(["--profile_steps", "1"])


def test_evaluate_gaze_accepts_on_device():
    parser = evaluate_gaze.build_parser()
    jparser = jeval.build_parser()
    for argv in (["--on_device"], ["--on_device", "--numpy_protocol"],
                 ["--numpy_protocol", "--on_device"], []):
        argv = ["--train_dir", "x"] + argv
        assert (parser.parse_args(argv).on_device
                == jparser.parse_args(argv).on_device)


def test_pretrain_shallownet_takes_salicon_root(tmp_path):
    """`--dataset salicon` trains on the tree under `--salicon_root` (the
    loader itself: tests/test_torch_salicon.py)."""
    from test_torch_salicon import salicon_tree

    root = salicon_tree(str(tmp_path / "salicon"), n=5)
    out = str(tmp_path / "sn.pt")
    assert pretrain_shallownet.main(["--dataset", "salicon", "--salicon_root",
                                     root, "--out", out, "--max_steps", "1",
                                     "--batch_size", "4", "--device",
                                     "cpu"]) == 0
    assert os.path.exists(out)
    args = pretrain_shallownet.build_parser().parse_args(
        ["--salicon_root", str(tmp_path), "--out", "x"])
    assert args.salicon_root == str(tmp_path)
    _no_card()
    with pytest.raises(RuntimeError, match="cuda"):
        pretrain_shallownet.main(["--salicon_root", str(tmp_path), "--out",
                                  str(tmp_path / "sn_card.pt")])
