"""The port's training surface around the step, on the CPU: the flip
augmentation, the synthetic corpus against the JAX package's, checkpoints,
and the `cli.train_gaze` entry point end to end."""

import json
import os

import numpy as np
import pytest
import torch

from recurrent_gaze_prediction_tpu.data import synthetic as jsynthetic
from recurrent_gaze_prediction_tpu_torch import registry
from recurrent_gaze_prediction_tpu_torch.cli import train_gaze
from recurrent_gaze_prediction_tpu_torch.config import OptimizerConfig
from recurrent_gaze_prediction_tpu_torch.data import synthetic
from recurrent_gaze_prediction_tpu_torch.data.datasets import BATCH_KEYS
from recurrent_gaze_prediction_tpu_torch.train import (
    Checkpointer, create_train_state, flip_half_batch)


def _flip_batch(b):
    rng = np.random.RandomState(0)
    return {"frames": torch.from_numpy(rng.rand(b, 2, 6, 5, 3)),
            "gazemaps": torch.from_numpy(rng.rand(b, 2, 4, 7)),
            "fixationmaps": torch.from_numpy(rng.rand(b, 2, 4, 7)),
            "c3d": torch.from_numpy(rng.rand(b, 2, 8, 7, 7)),
            "pupils": torch.from_numpy(rng.rand(b, 2))}


@pytest.mark.parametrize("b", [1, 4, 5])
def test_flip_half_batch_flips_exactly_half_on_the_stated_axes(b):
    batch = _flip_batch(b)
    out = flip_half_batch(batch, torch.Generator().manual_seed(3))
    axes = {"frames": 3, "gazemaps": 3, "fixationmaps": 3, "c3d": 4}
    flipped = [bool(torch.equal(out["c3d"][i], batch["c3d"][i].flip(3)))
               for i in range(b)]
    assert sum(flipped) == b // 2
    for key, axis in axes.items():
        for i in range(b):
            want = batch[key][i].flip(axis - 1) if flipped[i] \
                else batch[key][i]
            assert torch.equal(out[key][i], want), (key, i)
    assert torch.equal(out["pupils"], batch["pupils"])  # no axis: untouched
    again = flip_half_batch(batch, torch.Generator().manual_seed(3))
    assert all(torch.equal(out[k], again[k]) for k in out)


def test_synthetic_splits_equal_the_jax_package():
    kw = dict(n_train=3, n_valid=2, n_test=2, t=4, seed=5,
              gazemap_hw=(49, 49))
    ours, theirs = synthetic.make_splits(**kw), jsynthetic.make_splits(**kw)
    for split in ("train", "valid", "test"):
        a, b = getattr(ours, split), getattr(theirs, split)
        for key in BATCH_KEYS:
            np.testing.assert_array_equal(getattr(a, key), getattr(b, key))
        assert a.clipnames == b.clipnames
    batch = ours.train.next_batch(2)
    assert batch["c3d"].shape == (2, 4, 1024, 7, 7)


def _tiny_state():
    model = registry.create_model(
        "gaze_grcn", device="cpu", dim_feature=16, dim_cnn_proj=8,
        rnn_state_size=8, n_lstm_steps=2, compute_dtype="float32")
    return create_train_state(model, OptimizerConfig())


def test_checkpoint_save_restore_and_retention(tmp_path):
    state, _ = _tiny_state()
    ckpt = Checkpointer(str(tmp_path), max_to_keep=3)
    assert ckpt.restore_latest(state) is None
    saved = {}
    for step in range(1, 6):
        with torch.no_grad():
            state.params["cell.W_z"].add_(1.0)
        state.opt_state["mu"]["cell.U"].fill_(step)
        state.opt_state["count"] = state.step = step
        ckpt.save(state)
        saved[step] = state.params["cell.W_z"].detach().clone()
    assert ckpt.steps() == [3, 4, 5]
    assert os.path.exists(tmp_path / "model" / "5" / "state.pt")

    fresh, _ = _tiny_state()
    assert ckpt.restore_latest(fresh) is fresh
    assert fresh.step == 5 and fresh.opt_state["count"] == 5
    assert torch.equal(fresh.params["cell.W_z"], saved[5])
    assert bool((fresh.opt_state["mu"]["cell.U"] == 5).all())
    ckpt.restore(3, fresh)
    assert fresh.step == 3 and torch.equal(fresh.params["cell.W_z"],
                                           saved[3])
    stored = torch.load(tmp_path / "model" / "5" / "state.pt",
                        weights_only=True)
    assert "cell/W_z" in stored["params"]  # the JAX package's flat names


def _records(train_dir):
    """metrics.jsonl's training records (the final test-split evaluation
    writes its own `test/<metric>` record after each run)."""
    with open(os.path.join(train_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "loss/train" in r]


def test_cli_trains_writes_and_resumes(tmp_path):
    run = str(tmp_path / "run")
    argv = ["--device", "cpu", "--dataset", "synthetic", "--n_lstm_steps",
            "4", "--batch_size", "2", "--steps_per_logprint", "2",
            "--train_dir", run]
    assert train_gaze.main(argv + ["--max_steps", "4"]) == 0
    assert os.path.exists(os.path.join(run, "config.json"))
    assert Checkpointer(run).steps() == [4]
    first = _records(run)
    assert [r["step"] for r in first] == [2, 4]
    assert all(np.isfinite(r["loss/train"]) for r in first)
    cfg = Checkpointer.load_config(run)
    assert (cfg.model.n_lstm_steps, cfg.model.batch_size,
            cfg.model.dim_feature) == (4, 2, 1024)

    # a second run resumes at step 4 instead of starting over
    assert train_gaze.main(argv + ["--max_steps", "6"]) == 0
    assert Checkpointer(run).steps() == [4, 6]
    assert [r["step"] for r in _records(run)] == [2, 4, 6]


def test_cli_refuses_what_is_not_ported(monkeypatch):
    # the real-data loaders are ported: without --data_root the CLI
    # returns 1, as the JAX package's does
    assert train_gaze.main(["--device", "cpu", "--dataset", "crc"]) == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train_gaze.main(["--max_steps", "1"])
