"""The port's evaluation on the CPU: `eval/evaluator.py` against the JAX
package's on small gaze_grcn and gaze_lstm models (weights carried across
by `bridge.py`) over the synthetic valid split; the evaluation cadence of
`train.fit`; `cli.evaluate_gaze` on a short `cli.train_gaze` run; and the
checkpoint sweep.

Maps are held at rtol 1e-4 / atol 1e-8 (they are ~1/2401), scores at rtol
1e-4 / atol 1e-5. The scores compared across the packages leave out
AUC_shuffled (each package draws its own other-map union) and AUC_Judd
(its 1e-7 jitter is a random draw): `tests/test_torch_metrics.py` holds
those two against JAX on given inputs.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recurrent_gaze_prediction_tpu import registry as jregistry
from recurrent_gaze_prediction_tpu.eval import evaluator as jevaluator
from recurrent_gaze_prediction_tpu.train.state import (
    make_predict_fn as j_make_predict_fn)
from recurrent_gaze_prediction_tpu_torch import registry
from recurrent_gaze_prediction_tpu_torch.bridge import params_from_jax
from recurrent_gaze_prediction_tpu_torch.cli import evaluate_gaze, train_gaze
from recurrent_gaze_prediction_tpu_torch.config import ExperimentConfig
from recurrent_gaze_prediction_tpu_torch.data import synthetic
from recurrent_gaze_prediction_tpu_torch.eval import evaluator, metrics_torch
from recurrent_gaze_prediction_tpu_torch.eval.sweep import sweep_checkpoints
from recurrent_gaze_prediction_tpu_torch.eval.visualize import (
    decode_salicon_result, encode_salicon_result, imshow_grid)
from recurrent_gaze_prediction_tpu_torch.train import (
    Checkpointer, create_train_state, fit, make_predict_fn)

T = 4
METRICS = ("sim", "cc", "nss", "kld", "AUC_Borji")
MAP_TOL = dict(rtol=1e-4, atol=1e-8)
SCORE_TOL = dict(rtol=1e-4, atol=1e-5)
WIDTHS = dict(dim_feature=1024, dim_cnn_proj=8, rnn_state_size=8,
              compute_dtype="float32", n_lstm_steps=T, batch_size=2)


def _pair(name, seed=0):
    jmodel = jregistry.create_model(name, **WIDTHS)
    params = jmodel.init(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    params["cell"] = {k: jnp.asarray(rng.randn(*v.shape).astype(np.float32)
                                     * 0.3)
                      for k, v in params["cell"].items()}
    tmodel = registry.create_model(name, device="cpu", **WIDTHS)
    tmodel.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jmodel, params, tmodel


def _valid(n=5):
    return synthetic.make_splits(n_train=2, n_valid=n, n_test=2, t=T,
                                 seed=3).valid


@pytest.mark.parametrize("name", ["gaze_grcn", "gaze_lstm"])
def test_generate_and_evaluate_match_jax(name):
    """5 clips at B=2 (a short last batch), max_instances 4 and None."""
    jmodel, params, tmodel = _pair(name)
    jpredict, predict = j_make_predict_fn(jmodel), make_predict_fn(tmodel)
    data = _valid()
    for max_instances in (4, None):
        theirs = jevaluator.generate(jpredict, params, data, 2, max_instances)
        ours = evaluator.generate(predict, data, 2, max_instances,
                                  device="cpu")
        n = 4 * T if max_instances else 5 * T
        assert ours["pred_gazemaps"].shape == (n, 49, 49)
        np.testing.assert_allclose(ours["pred_gazemaps"],
                                   np.asarray(theirs["pred_gazemaps"]),
                                   **MAP_TOL)
        for key in ("gt_gazemaps", "fixationmaps", "images"):
            np.testing.assert_array_equal(ours[key], theirs[key])
        assert ours["clipnames"] == theirs["clipnames"]

        on_dev = evaluator.generate_on_device(predict, data, 2,
                                              max_instances, device="cpu")
        assert isinstance(on_dev["pred_gazemaps"], torch.Tensor)
        np.testing.assert_array_equal(on_dev["pred_gazemaps"].numpy(),
                                      ours["pred_gazemaps"])
        np.testing.assert_array_equal(on_dev["fixationmaps"].numpy(),
                                      ours["fixationmaps"])

        _, j_scores = jevaluator.generate_and_evaluate(
            jpredict, params, data, 2, max_instances, metrics=METRICS)
        for keep_maps in ("device", "host"):
            _, scores = evaluator.generate_and_evaluate(
                predict, data, 2, max_instances, metrics=METRICS,
                keep_maps=keep_maps, device="cpu")
            for m in METRICS:
                np.testing.assert_allclose(scores[m], j_scores[m],
                                           **SCORE_TOL, err_msg=m)


def test_evaluate_numpy_protocol_and_ragged_fallback():
    """on_device=False and ragged (mixed-resolution) fixation maps score
    through the NumPy protocol, as the JAX package's evaluate does."""
    rng = np.random.RandomState(0)
    preds = rng.rand(6, 9, 9).astype(np.float32)
    gts = rng.rand(6, 9, 9).astype(np.float32) + 0.05
    fixs = np.empty(6, dtype=object)
    for i in range(6):
        f = np.zeros((12, 12) if i % 2 else (9, 9), np.float32)
        f[rng.randint(0, 9, 3), rng.randint(0, 9, 3)] = 1.0
        fixs[i] = f
    metrics = ("cc", "sim", "nss")
    ours = evaluator.evaluate(preds, gts, fixs, metrics=metrics,
                              device="cpu")
    theirs = jevaluator.evaluate(preds, gts, fixs, metrics=metrics)
    assert ours == pytest.approx(theirs, rel=1e-12)


def _recorder():
    rows = []

    def write(step, values):
        rows.append((step, dict(values)))

    return rows, write


def test_fit_evaluation_cadence_writes_what_the_evaluator_gives():
    model = registry.create_model("gaze_grcn", device="cpu", **WIDTHS)
    exp = ExperimentConfig()
    exp.model = model.cfg
    exp.schedule.max_steps = 4
    exp.schedule.steps_per_evaluation = 2
    data = synthetic.make_splits(n_train=4, n_valid=4, n_test=2, t=T)
    state, tx = create_train_state(model, exp.optimizer)
    rows, write = _recorder()
    fit(model, state, tx, data, exp, metric_writer=write,
        max_eval_instances=3)
    evals = [(s, v) for s, v in rows if any(k.startswith("evaluation/")
                                              for k in v)]
    assert [s for s, _ in evals] == [2, 4]
    _, direct = evaluator.generate_and_evaluate(
        make_predict_fn(model), data.valid, 2, max_instances=3,
        device="cpu")
    assert evals[1][1] == {f"evaluation/{m}": s for m, s in direct.items()}
    assert set(direct) == set(metrics_torch.AVAILABLE_METRICS)
    assert all(np.isfinite(v) for v in direct.values())


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A gaze_grcn run of `cli.train_gaze` with checkpoints at steps 2 and
    4 (f32, T=4, B=2), its final test-split evaluation included."""
    run = str(tmp_path_factory.mktemp("run") / "run")
    argv = ["--device", "cpu", "--dataset", "synthetic", "--n_lstm_steps",
            str(T), "--batch_size", "2", "--synthetic_clips", "4",
            "--compute_dtype", "float32", "--steps_per_logprint", "2",
            "--train_dir", run]
    assert train_gaze.main(argv + ["--max_steps", "2"]) == 0
    assert train_gaze.main(argv + ["--max_steps", "4"]) == 0
    return run


def _restored(run, step=None):
    exp = Checkpointer.load_config(run)
    model = registry.create_model(exp.model.name, exp.model, device="cpu")
    state, _ = create_train_state(model, exp.optimizer)
    ckpt = Checkpointer(run)
    ckpt.restore(ckpt.latest_step() if step is None else step, state)
    valid = synthetic.make_splits(n_train=2, n_valid=8, n_test=2, t=T,
                                  seed=exp.seed).valid
    return model, valid


def test_train_cli_writes_the_final_test_evaluation(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    tests = [r for r in records if "test/cc" in r]
    assert [r["step"] for r in tests] == [2, 4]
    for r in tests:
        assert {k for k in r if k.startswith("test/")} == {
            f"test/{m}" for m in metrics_torch.AVAILABLE_METRICS}
        assert all(np.isfinite(r[f"test/{m}"])
                   for m in metrics_torch.AVAILABLE_METRICS)


def _read_outputs(out_dir):
    with open(os.path.join(out_dir, "overall.txt")) as f:
        overall = {k: float(v) for k, v in
                   (line.strip().split(": ") for line in f)}
    with open(os.path.join(out_dir, "scores.txt")) as f:
        header, *rows = f.read().splitlines()
    return overall, header, rows


@pytest.mark.parametrize("numpy_protocol", [False, True])
def test_evaluate_cli_writes_the_evaluators_scores(run_dir, tmp_path,
                                                   numpy_protocol):
    metrics = ["cc", "sim", "nss", "AUC_Judd", "AUC_Borji", "AUC_shuffled"]
    out = str(tmp_path / "eval")
    argv = ["--device", "cpu", "--train_dir", run_dir, "--out_dir", out,
            "--metrics", *metrics]
    assert evaluate_gaze.main(
        argv + (["--numpy_protocol"] if numpy_protocol else [])) == 0
    overall, header, rows = _read_outputs(out)
    assert header == "frame\t" + "\t".join(metrics)
    assert len(rows) == 8 * T
    assert rows[0].startswith("000000\t") and rows[-1].startswith(
        f"{8 * T - 1:06d}\t")
    per_frame = np.array([[float(x) for x in r.split("\t")[1:]]
                          for r in rows])

    model, valid = _restored(run_dir)
    ret = evaluator.generate(make_predict_fn(model), valid, 2, None,
                             device="cpu")
    want = evaluator.evaluate(ret["pred_gazemaps"], ret["gt_gazemaps"],
                              ret["fixationmaps"], metrics=metrics,
                              on_device=not numpy_protocol, device="cpu")
    assert overall == pytest.approx(want, rel=1e-6)
    np.testing.assert_allclose(np.nanmean(per_frame, 0),
                               [want[m] for m in metrics], atol=1e-6)


def test_evaluate_cli_refuses_what_is_not_ported(run_dir, monkeypatch):
    # sharded scoring is ported: in this one-rank world a mesh of 2 raises
    # the JAX package's error (multi-rank: tests/test_torch_parallel.py)
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices"):
        evaluate_gaze.main(["--device", "cpu", "--train_dir", run_dir,
                            "--data_parallel", "2"])
    # the real-data loaders are ported: without --data_root the CLI
    # returns 1, as the JAX package's does
    assert evaluate_gaze.main(["--device", "cpu", "--train_dir", run_dir,
                               "--dataset", "crc"]) == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        evaluate_gaze.main(["--train_dir", run_dir])


def test_sweep_checkpoints_scores_each_saved_step(run_dir):
    data = synthetic.make_splits(n_train=2, n_valid=4, n_test=2, t=T).valid
    results = sweep_checkpoints(run_dir, data, metrics=("cc", "sim"),
                                max_instances=4, device="cpu")
    assert sorted(results) == [2, 4]
    for step, scores in results.items():
        model, _ = _restored(run_dir, step)
        data.reset()
        _, want = evaluator.generate_and_evaluate(
            make_predict_fn(model), data, 2, 4, metrics=("cc", "sim"),
            device="cpu")
        assert scores == want
    assert results[2] != results[4]


def test_visualize_grid_and_salicon_round_trip():
    maps = np.random.RandomState(0).rand(5, 7, 9).astype(np.float32)
    grid = imshow_grid(maps, ncols=2)
    assert grid.shape == (3 * 8 - 1, 2 * 10 - 1) and grid.dtype == np.uint8
    record = encode_salicon_result(7, maps[0])
    back = decode_salicon_result(record)
    assert record["image_id"] == 7 and back.shape == (7, 9)
    assert back.min() == 0 and back.max() == 255
