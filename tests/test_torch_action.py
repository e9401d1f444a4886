"""The port's action task (`action/`, `cli.create_records`,
`cli.action_classification`) against the JAX package's, on the CPU in f32
with the same records and weights (`classification.params_from_jax`).

Records round trip and batch order equal; the classifier's logits at
rtol 1e-4 / atol 1e-5, its loss and every gradient at rtol 1e-3 / atol
1e-5 (NN with and without gaze attention, SVM with signed and raw
labels); five optimizer steps (Adam on the smooth decay, SGD) against
optax, the parameters at rtol 1e-3; `evaluate` equal; the CLIs' shards and
scores against the JAX CLIs'.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recurrent_gaze_prediction_tpu import action as jaction
from recurrent_gaze_prediction_tpu.action import classification as jclf
from recurrent_gaze_prediction_tpu.cli import (
    action_classification as jaction_cli)
from recurrent_gaze_prediction_tpu.cli import create_records as jrecords_cli
from recurrent_gaze_prediction_tpu_torch import action
from recurrent_gaze_prediction_tpu_torch.action import classification as clf
from recurrent_gaze_prediction_tpu_torch.cli import (action_classification,
                                                     create_records)
from test_torch_extract import _run_dirs

CPU = ["--device", "cpu"]


def _records(n=16, seed=0):
    """Frame records where class c correlates with C3D channel c
    (`tests/test_action.py::_fake_records`), every frame with a class."""
    rng = np.random.RandomState(seed)
    labels = np.zeros((n, 13), np.float32)
    labels[np.arange(n), rng.randint(0, 13, n)] = 1.0
    labels[rng.rand(n, 13) > 0.85] = 1.0
    c3d = rng.rand(n, 1024, 7, 7).astype(np.float32) * 0.1
    for i in range(n):
        c3d[i, int(np.argmax(labels[i]))] += 1.0
    return {
        "c3d": c3d,
        "frames": rng.rand(n, 98, 98, 3).astype(np.float32),
        "gaze_pred": rng.rand(n, 49, 49).astype(np.float32),
        "gaze_gt": rng.rand(n, 49, 49).astype(np.float32),
        "labels": labels,
    }


def _shards(folder, sizes, seed=0):
    folder.mkdir(exist_ok=True)
    paths = []
    for i, n in enumerate(sizes):
        path = str(folder / f"train-{i:05d}.npz")
        action.write_record_shard(path, **_records(n, seed + i))
        paths.append(path)
    return paths


# --------------------------------------------------------------- records

def test_records_match_jax(tmp_path):
    fields = _records(6)
    port, jax_path = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    action.write_record_shard(port, **fields)
    jaction.write_record_shard(jax_path, **fields)
    for reader in (action.read_record_shard, jaction.read_record_shard):
        for path in (port, jax_path):
            back = reader(path)
            for key in action.records.FIELDS:
                np.testing.assert_array_equal(back[key], fields[key])
    with pytest.raises(ValueError, match="missing"):
        action.write_record_shard(port, c3d=fields["c3d"])
    assert action.records.FIELDS == jaction.records.FIELDS

    paths = _shards(tmp_path / "shards", (7, 10, 3))
    for kwargs in (dict(), dict(shuffle_seed=3),
                   dict(shuffle_seed=1, drop_remainder=False)):
        got = list(action.iter_record_batches(paths, 3, **kwargs))
        want = list(jaction.iter_record_batches(paths, 3, **kwargs))
        # 20 frames: 6 batches of 3, and the remainder of 2 unless dropped
        assert len(got) == len(want) == (7 if kwargs.get(
            "drop_remainder", True) is False else 6)
        for g, w in zip(got, want):
            for key in action.records.FIELDS:
                np.testing.assert_array_equal(g[key], w[key])


def test_clipset_labels_match_jax(tmp_path):
    for k, name in enumerate(("Run", "Eat", "Kiss")):
        for split in ("train", "test"):
            (tmp_path / f"{name}_{split}.txt").write_text("".join(
                f"clip{i} {1 if (i + k) % 3 == 0 else -1}\n"
                for i in range(6)) + "\n")
    for split in ("train", "test"):
        got = action.load_clipset_labels(str(tmp_path), split)
        assert got == jaction.load_clipset_labels(str(tmp_path), split)
        assert got
    with pytest.raises(NameError):
        action.load_clipset_labels(str(tmp_path), "valid")
    np.testing.assert_array_equal(action.multi_hot([0, 5]),
                                  jaction.multi_hot([0, 5]))


# ------------------------------------------------------------ classifier

HEADS = [
    ("NN", False, True), ("NN", True, True), ("SVM", False, True),
    ("SVM", True, False), ("SVM", False, False)]


def _jax_params(hp, seed=0):
    """The JAX package's init, every leaf redrawn from a seed (the SVM's
    zero init would leave the hinge's gradient trivial)."""
    params = jclf.init_params(jax.random.PRNGKey(seed), hp)
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*v.shape) * (0.05 if v.ndim == 2 else 0.1))
            .astype(np.float32) for k, v in params.items()}


@pytest.mark.parametrize("head,use_gazemap,signed", HEADS)
def test_classifier_logits_loss_and_grads_match_jax(head, use_gazemap,
                                                    signed):
    hp = jclf.ActionHParams(head=head, use_gazemap=use_gazemap,
                            svm_signed_labels=signed)
    thp = clf.ActionHParams(head=head, use_gazemap=use_gazemap,
                            svm_signed_labels=signed)
    jparams = _jax_params(hp)
    params = clf.params_from_jax(jparams, device="cpu")
    batch = {k: v for k, v in _records(4, seed=1).items()
             if k in clf.BATCH_KEYS}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = clf.batch_to(batch, torch.device("cpu"))
    gaze = jbatch["gaze_pred"] if use_gazemap else None

    want = jclf.logits_fn(jparams, jbatch["c3d"], gaze, hp)
    got = clf.logits_fn(params, tbatch["c3d"],
                        tbatch["gaze_pred"] if use_gazemap else None, thp)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        clf.predict_proba(params, tbatch, thp).detach().numpy(),
        np.asarray(jclf.predict_proba(jparams, jbatch, hp)),
        rtol=1e-4, atol=1e-5)

    jloss, jgrads = jax.value_and_grad(jclf.loss_fn)(jparams, jbatch, hp)
    loss = clf.loss_fn(params, tbatch, thp)
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-3,
                               atol=1e-5)
    assert sorted(params) == sorted(jgrads)
    for name, g in zip(params, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[name]),
                                   rtol=1e-3, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("head,use_gazemap", [("NN", True), ("SVM", False)])
def test_five_optimizer_steps_match_optax(head, use_gazemap):
    hp = jclf.ActionHParams(head=head, use_gazemap=use_gazemap, max_iter=5)
    thp = clf.ActionHParams(head=head, use_gazemap=use_gazemap, max_iter=5)
    jparams = _jax_params(hp, seed=2)
    batches = [_records(4, seed=10 + i) for i in range(5)]

    jmodel = jclf.ActionClassifier(hp)
    jmodel.params = {k: jnp.asarray(v) for k, v in jparams.items()}
    jmodel.opt_state = jmodel.tx.init(jmodel.params)
    jlosses = jmodel.fit(batches)
    model = clf.ActionClassifier(thp, device="cpu")
    model.params = clf.params_from_jax(jparams, "cpu")
    model.opt_state = model.tx.init(model.params)
    losses = model.fit(batches)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3, atol=1e-5)
    assert model.opt_state["count"] == 5
    # Adam divides each element's mean gradient by its own RMS, so an
    # element whose batch gradient nearly cancels carries f32 summation
    # noise into a step of ~lr: 21 of 12.9M NN elements move up to 7e-5
    # (3.5% of lr) apart; every other one holds rtol 1e-3 / atol 1e-5
    n_off = n_all = 0
    for name, p in model.params.items():
        got, want = p.detach().numpy(), np.asarray(jmodel.params[name])
        n_off += int((np.abs(got - want) > 1e-5 + 1e-3 * np.abs(want)).sum())
        n_all += want.size
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4,
                                   err_msg=name)
    assert n_off <= 1e-5 * n_all, n_off
    np.testing.assert_allclose(model.predict(batches[0]),
                               jmodel.predict(batches[0]),
                               rtol=1e-3, atol=1e-5)


def test_learning_rate_schedule_and_init(tmp_path):
    tx = clf.make_optimizer(clf.ActionHParams())
    for step in (0, 1, 5, 10, 37):
        assert tx.schedule(step) == pytest.approx(
            0.002 * 0.96 ** (step / 10), rel=1e-6)
    assert isinstance(clf.make_optimizer(clf.ActionHParams(head="SVM")),
                      clf.SGD)
    for head, gaze in (("NN", True), ("SVM", False)):
        hp = clf.ActionHParams(head=head, use_gazemap=gaze)
        got = clf.init_params(hp, torch.Generator().manual_seed(0),
                              device="cpu")
        want = jclf.init_params(jax.random.PRNGKey(0),
                                jclf.ActionHParams(head=head,
                                                   use_gazemap=gaze))
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
    w = clf.init_params(clf.ActionHParams(use_gazemap=True),
                        torch.Generator().manual_seed(0), device="cpu")
    assert w["gaze_proj_W"].abs().max() <= 0.1  # truncated at 2 sigma
    assert float(w["gaze_proj_W"].detach().std()) == pytest.approx(
        0.044, rel=0.05)
    limit = float(np.sqrt(6.0 / (50176 + 256)))
    assert float(w["h1_w"].abs().max()) <= limit
    model = clf.ActionClassifier(clf.ActionHParams(use_gazemap=True),
                                 device="cpu")
    path = str(tmp_path / "clf.pt")
    model.save(path)
    back = clf.ActionClassifier.load(path, clf.ActionHParams(
        use_gazemap=True, seed=5), device="cpu")
    for name, p in model.params.items():
        torch.testing.assert_close(back.params[name], p)


def test_evaluate_matches_jax():
    rng = np.random.RandomState(4)
    y_true = (rng.rand(40, 13) > 0.7).astype(np.float32)
    y_true[:, 3] = 0  # a class with no positive: NaN AP in both
    y_score = rng.rand(40, 13).astype(np.float32)
    for threshold in (0.5, 0.0):
        got = clf.evaluate(y_true, y_score, threshold)
        want = jclf.evaluate(y_true, y_score, threshold)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
    assert np.isnan(got["per_class_ap"][3])


# ------------------------------------------------------------------ CLIs

def test_create_records_cli_matches_jax(tmp_path):
    jdir, tdir = _run_dirs(tmp_path, "gaze_grcn", n_lstm_steps=3,
                           batch_size=3)
    clipsets = tmp_path / "ClipSets"
    clipsets.mkdir()
    (clipsets / "Run_train.txt").write_text("synthetic_0000 1\n")
    shards = {}
    for tag, main, run, extra in (("port", create_records.main, tdir, CPU),
                                  ("jax", jrecords_cli.main, jdir, [])):
        out = str(tmp_path / f"records_{tag}")
        assert main(["--train_dir", run, "--out_dir", out, "--shard_size",
                     "10", "--clipsets_dir", str(clipsets)] + extra) == 0
        shards[tag] = sorted(glob.glob(os.path.join(out, "*.npz")))
    assert [os.path.basename(p) for p in shards["port"]] == \
        [os.path.basename(p) for p in shards["jax"]]
    assert len(shards["port"]) >= 2
    for got_path, want_path in zip(shards["port"], shards["jax"]):
        got = action.read_record_shard(got_path)
        want = action.read_record_shard(want_path)
        for key in ("c3d", "frames", "gaze_gt", "labels"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        np.testing.assert_allclose(got["gaze_pred"], want["gaze_pred"],
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("args", [
    ["--head", "NN", "--use_gazemap"], ["--head", "SVM"],
    ["--head", "SVM", "--reference_hinge"]])
def test_action_classification_cli_matches_jax(tmp_path, monkeypatch, args):
    """Both CLIs from the same first weights: the port's init is swapped
    for the JAX package's draw (the SVM's is zeros in both anyway)."""
    train = _shards(tmp_path / "train", (9, 7))
    _shards(tmp_path / "test", (8,), seed=5)
    hp_args = dict(head=args[1], use_gazemap="--use_gazemap" in args)
    jinit = jclf.init_params(jax.random.PRNGKey(0),
                             jclf.ActionHParams(**hp_args))
    monkeypatch.setattr(clf, "init_params", lambda hp, gen, device: (
        clf.params_from_jax(jinit, device)))
    scores = {}
    common = ["--records_glob", os.path.join(os.path.dirname(train[0]),
                                             "train-*.npz"),
              "--eval_records_glob", str(tmp_path / "test" / "*.npz"),
              "--batch_size", "4", "--max_iter", "6"] + args
    for tag, main, extra in (("port", action_classification.main, CPU),
                             ("jax", jaction_cli.main, [])):
        out = str(tmp_path / f"{tag}.json")
        assert main(common + ["--out", out] + extra) == 0
        scores[tag] = json.load(open(out))
    assert sorted(scores["port"]) == sorted(scores["jax"])
    for key in ("hamming_loss", "zero_one_loss"):
        assert scores["port"][key] == scores["jax"][key]
    np.testing.assert_allclose(scores["port"]["mean_average_precision"],
                               scores["jax"]["mean_average_precision"],
                               rtol=1e-4)
    np.testing.assert_allclose(
        np.asarray(scores["port"]["per_class_ap"], np.float64),
        np.asarray(scores["jax"]["per_class_ap"], np.float64), rtol=1e-4)
    assert action_classification.main(
        ["--records_glob", str(tmp_path / "none-*.npz")] + CPU) == 1
