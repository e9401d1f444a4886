"""Observability of the port on the CPU: the profiler hooks and `fit`'s
profiler window (`train/profiler.py`, `cli.train_gaze --profile_steps`),
the MFU accounting (`utils/mfu.py`) and the parameter tree helpers
(`utils/tree.py`) against the JAX package's."""

import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from recurrent_gaze_prediction_tpu import registry as jregistry
from recurrent_gaze_prediction_tpu.utils import tree as jtree
from recurrent_gaze_prediction_tpu_torch import registry
from recurrent_gaze_prediction_tpu_torch.cli import train_gaze
from recurrent_gaze_prediction_tpu_torch.config import ExperimentConfig
from recurrent_gaze_prediction_tpu_torch.data import synthetic
from recurrent_gaze_prediction_tpu_torch.data.datasets import DataSplits
from recurrent_gaze_prediction_tpu_torch.train import (create_train_state,
                                                       fit, loop, profiler)
from recurrent_gaze_prediction_tpu_torch.utils import mfu, tree

TINY = dict(dim_feature=16, dim_cnn_proj=8, rnn_state_size=8,
            compute_dtype="float32")


def _traces(log_dir):
    return sorted(glob.glob(os.path.join(log_dir, "*.pt.trace.json")))


def _tiny_run(max_steps=4):
    model = registry.create_model("gaze_grcn", device="cpu", n_lstm_steps=2,
                                  batch_size=2, **TINY)
    exp = ExperimentConfig()
    exp.model = model.cfg
    exp.schedule.max_steps = max_steps
    exp.schedule.steps_per_logprint = 1
    state, tx = create_train_state(model, exp.optimizer)
    data = synthetic.make_clip_windows(4, 2, seed=0)
    # the synthetic corpus carries 1024 features; keep TINY's 16
    data.c3d = np.ascontiguousarray(data.c3d[:, :, :16])
    return model, state, tx, DataSplits(train=data, valid=None, test=None), \
        exp


def _warnings(monkeypatch):
    said = []
    monkeypatch.setattr(loop.log, "warn",
                        lambda msg, *args: said.append(msg % args))
    return said


def test_train_gaze_profile_steps_captures_trace(tmp_path):
    """`--profile_steps 2` traces live train steps into
    {train_dir}/profile (the JAX package's
    `test_fit_profile_steps_captures_trace`)."""
    run = str(tmp_path / "run")
    assert train_gaze.main([
        "--model", "gaze_grcn77", "--dataset", "synthetic", "--max_steps",
        "6", "--n_lstm_steps", "4", "--batch_size", "2", "--synthetic_clips",
        "4", "--compute_dtype", "float32", "--train_dir", run,
        "--profile_steps", "2", "--device", "cpu"]) == 0
    traces = _traces(os.path.join(run, "profile"))
    assert len(traces) == 1, "no torch profiler trace captured"
    with open(traces[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::convolution" in names  # the steps' convs are in it
    assert not torch._C._autograd._profiler_enabled()


def test_fit_window_stops_on_an_exception(tmp_path):
    """An exception inside the window leaves no profiler running and the
    trace written (the `finally` of fit)."""
    model, state, tx, data, exp = _tiny_run()

    def batches():
        batch = data.train.next_batch(2)
        yield {k: v for k, v in batch.items() if k != "clipnames"}
        raise RuntimeError("the data source failed")

    with pytest.raises(RuntimeError, match="data source"):
        fit(model, state, tx, data, exp, train_dir=str(tmp_path),
            train_iterator=batches(), profile_steps=5, profile_start=1)
    assert not torch._C._autograd._profiler_enabled()
    assert len(_traces(str(tmp_path / "profile"))) == 1


def test_fit_window_warns_when_it_cannot_trace(tmp_path, monkeypatch):
    said = _warnings(monkeypatch)
    model, state, tx, data, exp = _tiny_run(max_steps=2)
    fit(model, state, tx, data, exp, profile_steps=2)
    assert any("train_dir is unset" in s for s in said)
    said.clear()
    model, state, tx, data, exp = _tiny_run(max_steps=2)
    fit(model, state, tx, data, exp, train_dir=str(tmp_path),
        profile_steps=2, profile_start=10)
    assert any("nothing was traced" in s for s in said)
    assert not os.path.exists(tmp_path / "profile")


def test_profile_steps_labels_each_step(tmp_path):
    """`profile_steps` (the JAX package's `test_profiler_hooks_run`): a
    trace in the directory, one `step_<i>` range per call."""
    x = torch.ones(8, 8)
    prof = profiler.profile_steps(lambda a: a @ a * 2.0, (x,), 2,
                                  str(tmp_path / "trace"))
    assert len(_traces(str(tmp_path / "trace"))) == 1
    keys = {e.key: e.count for e in prof.key_averages()}
    assert keys.get("step_0") == keys.get("step_1") == 1


def test_mfu_accounting(monkeypatch):
    """`compiled_flops` of a 512^3 matmul is exactly 2*512^3; on the CPU
    the peak is unknown, so `mfu` is None; with a peak for the card's name
    the arithmetic holds (the JAX package's `test_mfu_accounting`)."""
    x = torch.ones(512, 512)
    assert mfu.compiled_flops(torch.matmul, x, x) == 2 * 512 ** 3
    assert mfu.peak_flops("cpu") is None
    assert mfu.mfu(1e9, 10.0, "cpu") is None
    assert mfu.PEAK_FLOPS_PER_CHIP == {"NVIDIA H100 80GB HBM3": 989e12}
    monkeypatch.setitem(mfu.PEAK_FLOPS_PER_CHIP, "FakeChip", 100e9)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None:
                        "FakeChip")
    assert abs(mfu.mfu(1e9, 10.0, "cuda") - 0.1) < 1e-12
    assert mfu.mfu(None, 10.0, "cuda") is None


def _hand_count(n, f, p, u):
    """gaze_grcn's predict over n = B*T frames below the decoder's
    composition threshold: projection, input-side conv, the recurrence's
    two state convs, the head folded into the last deconv's kernel, and
    the three deconvs (5x5/s3, 5x5/s2, 7x7/s1 SAME)."""
    return (2 * n * 49 * f * p + 2 * n * 49 * 9 * p * 3 * u
            + 2 * n * 49 * 9 * u * 3 * u + 2 * 49 * 32 * 12
            + 2 * n * 49 * 25 * u * 64 + 2 * n * 23 ** 2 * 25 * 64 * 32
            + 2 * n * 49 ** 2 * 49 * 32)


@pytest.mark.parametrize("b,t,units", [(2, 3, 16), (1, 4, 32)])
def test_plain_route_predict_count_equals_hand_count(b, t, units):
    model = registry.create_model("gaze_grcn", device="cpu", n_lstm_steps=t,
                                  **{**TINY, "rnn_state_size": units})
    c3d = torch.randn(b, t, 16, 7, 7)
    counts = mfu.flop_counts(model.predict, None, c3d)
    # the kernel route, whose wrapper runs its plain version on a CPU
    # tensor: the recurrence is counted as aten convolutions
    assert model.last_route == "kernel" and "convgru_fwd" not in counts
    assert sum(counts.values()) == _hand_count(b * t, 16, 8, units)
    assert mfu.compiled_flops(model.predict, None, c3d) == _hand_count(
        b * t, 16, 8, units)


def test_kernel_flops_reach_every_open_counter():
    """A kernel wrapper's count lands in every counter open on its thread,
    forward and in an autograd backward, and nowhere else."""
    class Kernel(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            mfu.add_kernel_flops("fwd_kernel", 7)
            return x * 2

        @staticmethod
        def backward(ctx, g):
            mfu.add_kernel_flops("bwd_kernel", 11)
            return g * 2

    x = torch.ones(3, requires_grad=True)
    mfu.add_kernel_flops("fwd_kernel", 5)  # no counter open: no effect

    def step():
        Kernel.apply(x).sum().backward()

    assert mfu.flop_counts(step) == {"fwd_kernel": 7, "bwd_kernel": 11}
    inner = {}

    def nested():
        inner.update(mfu.flop_counts(step))
        torch.matmul(torch.ones(2, 2), torch.ones(2, 2))

    outer = mfu.flop_counts(nested)
    assert inner == {"fwd_kernel": 7, "bwd_kernel": 11}
    assert outer == {"fwd_kernel": 7, "bwd_kernel": 11, "aten.mm": 16}


@pytest.mark.parametrize("name", registry.available_models())
def test_tree_counts_match_jax(name):
    """`param_count`, `param_bytes` and `describe`'s total of every family
    at its registry widths equal the JAX package's; `describe` lists the
    JAX flat names."""
    model = registry.create_model(name, device="cpu")
    params = jregistry.create_model(name).init(jax.random.PRNGKey(0))
    assert tree.param_count(model) == jtree.param_count(params)
    assert tree.param_bytes(model) == jtree.param_bytes(params)
    assert tree.param_count(dict(model.named_parameters())) == \
        jtree.param_count(params)
    text = tree.describe(model)
    assert text.splitlines()[-1] == jtree.describe(params).splitlines()[-1]
    assert "cell/" in text or "/" in text.splitlines()[0]


def test_cast_floating_leaves_integers():
    params = {"w": torch.ones(2, 3), "step": torch.tensor([4])}
    cast = tree.cast_floating(params, torch.bfloat16)
    assert cast["w"].dtype == torch.bfloat16
    assert cast["step"].dtype == torch.int64
    assert tree.param_bytes(cast) == 2 * 6 + 8
