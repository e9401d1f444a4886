"""Fault C3: every flag of the JAX package's `cli.train_gaze`,
`cli.evaluate_gaze`, `cli.pretrain_shallownet` and `cli.export_serving` is
known to the port's counterpart, so no JAX command line fails there as
"unrecognized arguments". A flag the port does not carry out yet exits 2
naming the ROADMAP item that brings it; the others parse as in the JAX
package.
"""

import os

import pytest
import torch

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


@pytest.mark.parametrize("argv,item", [
    (["--data_parallel", "2"], "item 6"),
    (["--data_parallel", "-1"], "item 6"),
    (["--model_parallel", "2"], "item 6"),
])
def test_train_gaze_refuses_unported_flags_by_name(argv, item, capsys):
    with pytest.raises(SystemExit) as exc:
        train_gaze.main(argv + ["--device", "cpu"])
    assert exc.value.code == 2
    assert item in capsys.readouterr().err


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
