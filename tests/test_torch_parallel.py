"""The port's multi-rank layer (`parallel/`) on the CPU. Ranks are gloo
processes on 127.0.0.1 (`torch_parallel_worker.py`, one launch of 2 ranks
and one of 4 for the module, each with its timeout); each result is held
against the JAX package's UNSHARDED function on the same inputs, run here
on one device:

  * a 2-rank data-parallel train step against `make_train_step` (loss
    rtol 1e-5, params rtol 1e-4 / atol 1e-6, the JAX package's sharding
    tolerances; SGD, whose update is proportional to the gradient);
  * a 2x2 data x model mesh (gaze_grcn's 1024->512 projection, and
    gaze_pupil_gru2's tied output projection, split over "model") against
    the same: the gradients, read back from one SGD step at lr 1 with the
    clip active, at rtol 1e-3 / atol 1e-5, and the clip's global norm;
  * `shard_batch`'s pass-through, predict with a tail batch (B=5 on 2
    ranks), a batch of streams, the fused predict and the fused train step
    (frozen and fine-tuned tower), and scoring of rank-map predictions with
    an explicit other map;
  * `fit` over a mesh, resumed from a one-process checkpoint on 2 ranks
    and on 2x2, and the reverse, against one-process runs from the same
    checkpoints (rtol 2e-5, as the JAX package), its validation and
    evaluation cadences running;
  * `cli.train_gaze --data_parallel -1`, `cli.evaluate_gaze
    --data_parallel 2` and `cli.train_fused --data_parallel 2` under a
    2-rank launch;
  * checkpoints when the ranks see different train_dirs: rank 0 decides
    whether a step is saved and which one to restore;
  * `make_mesh`'s errors and `make_hybrid_mesh`'s flat fallback.

Flip and dropout are off wherever numbers are compared: the two packages
draw different random numbers, and N ranks draw dropout per data rank.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recurrent_gaze_prediction_tpu import registry as jregistry
from recurrent_gaze_prediction_tpu.config import OptimizerConfig as JOptCfg
from recurrent_gaze_prediction_tpu.data import synthetic as jsynthetic
from recurrent_gaze_prediction_tpu.eval import metrics_jax
from recurrent_gaze_prediction_tpu.models import pipeline as jpipeline
from recurrent_gaze_prediction_tpu.models import streaming as jstreaming
from recurrent_gaze_prediction_tpu.train.state import TrainState as JState
from recurrent_gaze_prediction_tpu.train.state import (
    build_optimizer as j_build_optimizer)
from recurrent_gaze_prediction_tpu.train.state import (
    make_train_step as j_make_train_step)
from recurrent_gaze_prediction_tpu_torch import parallel, registry
from recurrent_gaze_prediction_tpu_torch.bridge import flatten_params
from recurrent_gaze_prediction_tpu_torch.cli import evaluate_gaze
from recurrent_gaze_prediction_tpu_torch.config import ExperimentConfig
from recurrent_gaze_prediction_tpu_torch.data import synthetic
from recurrent_gaze_prediction_tpu_torch.train import create_train_state, fit
from test_torch_c3d import jax_c3d_params
from test_torch_train_fused import _positive_tower
from torch_parallel_worker import Recorder, launch, results_of

T, B = 4, 8
SMALL = dict(n_lstm_steps=T, dim_cnn_proj=16, rnn_state_size=8,
             compute_dtype="float32", dropout_keep_prob=1.0,
             use_flip_batch=False)
SGD = dict(method="sgd", initial_learning_rate=1e-2)
MAP_TOL = dict(rtol=1e-4, atol=1e-6)
SCORE_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
RESUME_RTOL = 2e-5


def _jax_model(name, seed=0, **widths):
    """A JAX model and its params with the cell (if any) scaled x0.3 from
    a numpy draw, so the recurrence is far from zero."""
    jmodel = jregistry.create_model(name, **widths)
    params = jmodel.init(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    if "cell" in params:
        params["cell"] = {k: jnp.asarray(
            rng.randn(*v.shape).astype(np.float32) * 0.3)
            for k, v in params["cell"].items()}
    return jmodel, params


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _spec(name, params, widths, **more):
    return dict(name=name, params=_np(params), widths=widths, **more)


def _batches(n, b, t, hw, seed=0):
    data = jsynthetic.make_splits(n_train=n * b, n_valid=0, n_test=0, t=t,
                                  gazemap_hw=hw, seed=seed)
    return [{k: v for k, v in data.train.next_batch(b).items()
             if k != "clipnames"} for _ in range(n)]


def _jax_steps(jmodel, params, opt, batches):
    """The JAX package's unsharded train step over `batches`: (losses,
    grad norms, flat params after each step)."""
    jtx = j_build_optimizer(JOptCfg(**opt), params)
    state = JState(params=params, opt_state=jtx.init(params),
                   step=jnp.zeros((), jnp.int32))
    step = j_make_train_step(jmodel, jtx, use_flip=False, donate=False)
    losses, norms, flats = [], [], []
    for batch in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                        jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        flats.append(flatten_params(_np(state.params)))
    return losses, norms, flats


# ------------------------------------------------------------- the inputs

def _fit_exp(name="gaze_grcn77") -> ExperimentConfig:
    exp = ExperimentConfig()
    exp.model.name = name
    for k, v in SMALL.items():
        setattr(exp.model, k, v)
    exp.model.batch_size = 4
    exp.schedule.steps_per_logprint = 1
    exp.schedule.steps_per_checkpoint = 1000  # only fit's final save
    exp.schedule.steps_per_validation = 2
    exp.schedule.steps_per_evaluation = 2
    return exp


SPLITS = dict(n_train=8, n_valid=4, n_test=0, t=T, gazemap_hw=(7, 7),
              seed=5)


def _fit_one(train_dir, max_steps):
    """`fit` in this process, no mesh: the rows its writer got."""
    exp = _fit_exp()
    exp.schedule.max_steps = max_steps
    model = registry.create_model(
        exp.model.name, exp.model, device="cpu",
        generator=torch.Generator().manual_seed(exp.seed))
    state, tx = create_train_state(model, exp.optimizer)
    writer = Recorder()
    fit(model, state, tx, synthetic.make_splits(**SPLITS), exp,
        train_dir=train_dir, metric_writer=writer, max_eval_instances=4)
    return writer.rows


def _train_losses(rows) -> dict:
    return {s: m["loss/train"] for s, m in rows if "loss/train" in m}


def _fused_spec(finetune: bool, b: int = 2, f: int = 16):
    t = jpipeline.pipeline_timesteps(f)
    widths = dict(n_lstm_steps=t, dim_cnn_proj=32, rnn_state_size=16,
                  compute_dtype="float32", dropout_keep_prob=1.0,
                  use_flip_batch=False)
    jmodel, params = _jax_model("gaze_grcn", 0, **widths)
    if finetune:
        c3d = _positive_tower(1)
    else:
        c3d = jax_c3d_params(seed=1, fc=False)
        c3d["conv1a_w"] = c3d["conv1a_w"] / 128.0
    rng = np.random.RandomState(7)
    batch = {"video": rng.randint(0, 256, (b, f, 128, 171, 3)).astype(
                 np.uint8),
             "gazemaps": np.abs(rng.randn(b, t, 49, 49)).astype(np.float32)}
    opt = dict(method="sgd", initial_learning_rate=1e-3)
    return jmodel, params, c3d, _spec("gaze_grcn", params, widths, c3d=c3d,
                                      batch=batch, opt=opt,
                                      finetune=finetune)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """One 2-rank launch of every data-parallel scenario; returns
    (inputs, results, dirs)."""
    work = str(tmp_path_factory.mktemp("world2"))
    inputs = {"mesh": (2, 1)}

    jmodel, params = _jax_model("gaze_grcn77", **SMALL)
    inputs["train"] = _spec("gaze_grcn77", params, SMALL, opt=SGD,
                            batches=_batches(2, B, T, (7, 7)))
    inputs["shard_batch"] = {}
    tail = _batches(1, 5, T, (7, 7), seed=3)[0]
    inputs["predict"] = _spec("gaze_grcn77", params, SMALL,
                              frames=tail["frames"], c3d=tail["c3d"])
    gparams = _jax_model("gaze_grcn", 1, **SMALL)[1]
    inputs["stream"] = _spec("gaze_grcn", gparams, SMALL, chunk=4,
                             feats=np.random.RandomState(0).rand(
                                 4, 8, 1024, 7, 7).astype(np.float32))
    for finetune in (False, True):
        inputs[f"fused_train:{finetune}"] = _fused_spec(finetune)[3]
    spec = _fused_spec(False, b=3)[3]
    inputs["fused_predict"] = dict(spec, video=spec["batch"]["video"])

    rng = np.random.RandomState(11)
    n = 37  # pads to 38 on 2 ranks
    pred = np.stack([rng.permutation(49 * 49).reshape(49, 49)
                     for _ in range(n)]).astype(np.float32) / (49 * 49)
    fixation = (rng.rand(n, 49, 49) > 0.995).astype(np.float32)
    fixation[3] = 0.0  # a frame with no fixation: NaN where the JAX has it
    inputs["evaluate"] = dict(
        pred=pred, gt=rng.rand(n, 49, 49).astype(np.float32) + 0.01,
        fixation=fixation, other_map=(rng.rand(49, 49) > 0.97).astype(
            np.float32), metrics=tuple(metrics_jax.AVAILABLE_METRICS))

    inputs["checkpoint_views"] = _spec(
        "gaze_grcn77", params, SMALL, opt=SGD,
        dirs=[os.path.join(work, f"views{r}") for r in range(2)])

    # fit: a one-process checkpoint at step 2 (dir a, copied to b); b
    # resumed to 4 here; b's step-4 checkpoint copied to c
    dirs = {k: os.path.join(work, k) for k in ("a", "b", "c", "d")}
    _fit_one(dirs["a"], 2)
    shutil.copytree(dirs["a"], dirs["b"])
    shutil.copytree(dirs["a"], dirs["d"])
    one_resumed = _fit_one(dirs["b"], 4)
    shutil.copytree(dirs["b"], dirs["c"])
    inputs["fit_run"] = dict(exp=_fit_exp(), splits=SPLITS,
                             runs=[(dirs["a"], 4), (dirs["c"], 6)])

    run = os.path.join(work, "cli_run")
    common = ["--device", "cpu"]
    inputs["cli"] = dict(
        train=["--dataset", "synthetic", "--max_steps", "2",
               "--n_lstm_steps", "2", "--batch_size", "2",
               "--synthetic_clips", "4", "--compute_dtype", "float32",
               "--steps_per_logprint", "1", "--data_parallel", "-1",
               "--no_prefetch", "--train_dir", run] + common,
        eval=["--train_dir", run, "--data_parallel", "2",
              "--metrics", "cc", "sim", "nss"] + common,
        fused=["--dataset", "synthetic", "--num_frames", "16",
               "--batch_size", "2", "--synthetic_clips", "2",
               "--compute_dtype", "float32", "--max_steps", "2",
               "--data_parallel", "2", "--train_dir",
               os.path.join(work, "fused_run")] + common)
    names = ["train", "shard_batch", "predict", "stream", "fused_predict",
             "fused_train:False", "fused_train:True", "evaluate",
             "checkpoint_views", "fit_run", "cli"]
    results = launch(work, 2, inputs, names, timeout=400)
    return inputs, results, dict(dirs, one_resumed=one_resumed, cli=run)


@pytest.fixture(scope="module")
def world4(world2, tmp_path_factory):
    """One 4-rank launch on a 2x2 data x model mesh."""
    work = str(tmp_path_factory.mktemp("world4"))
    inputs = {"mesh": (2, 2)}
    wide = dict(SMALL, n_lstm_steps=3, dim_cnn_proj=512)
    jmodel, params = _jax_model("gaze_grcn", 2, **wide)
    batches = [{k: v[:4] for k, v in b.items()}
               for b in _batches(1, 4, 3, (49, 49), seed=1)]
    gru2 = dict(n_lstm_steps=3, compute_dtype="float32",
                dropout_keep_prob=1.0, use_flip_batch=False)
    _, gru2_params = _jax_model("gaze_pupil_gru2", 3, **gru2)
    refs = {}
    for key, name, p, widths, jm, bs in (
            ("train:mp", "gaze_grcn", params, wide, jmodel, batches),
            ("train:gru2", "gaze_pupil_gru2", gru2_params, gru2,
             jregistry.create_model("gaze_pupil_gru2", **gru2),
             _batches(1, 4, 3, (7, 7), seed=2))):
        # the clip at half the gradient's norm, so it acts
        _, norms, _ = _jax_steps(jm, p, dict(method="sgd",
                                             initial_learning_rate=1.0), bs)
        opt = dict(method="sgd", initial_learning_rate=1.0,
                   max_grad_norm=norms[0] / 2)
        refs[key] = (_jax_steps(jm, p, opt, bs), flatten_params(_np(p)))
        inputs[key] = _spec(name, p, widths, opt=opt, batches=bs)
    # fit: the one-process checkpoint of step 2 resumed on 2x2
    dirs = world2[2]
    resume = os.path.join(work, "fit")
    shutil.copytree(dirs["d"], resume)
    inputs["fit_run"] = dict(exp=_fit_exp(), splits=SPLITS,
                             runs=[(resume, 6)])
    results = launch(work, 4, inputs,
                     ["train:mp", "train:gru2", "fit_run"], timeout=300)
    return inputs, results, refs


# ------------------------------------------------------------------ tests

def test_data_parallel_train_step_matches_jax(world2):
    inputs, results, _ = world2
    spec = inputs["train"]
    jmodel = jregistry.create_model(spec["name"], **spec["widths"])
    losses, norms, flats = _jax_steps(jmodel, spec["params"], spec["opt"],
                                      spec["batches"])
    for rank in results_of(results, "train"):
        np.testing.assert_allclose(rank["loss"], losses, rtol=1e-5)
        np.testing.assert_allclose(rank["grad_norm"], norms, rtol=1e-5)
        for got, want in zip(rank["params"], flats):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                           atol=1e-6, err_msg=k)


@pytest.mark.parametrize("key", ["train:mp", "train:gru2"])
def test_model_parallel_gradients_match_jax(world4, key):
    """2x2 mesh: the sliced weights' gradients (the gather's backward
    slices the cotangent, it does not sum it) and the clip by the global
    norm summed over the model group."""
    _, results, refs = world4
    (losses, norms, flats), before = refs[key]
    split = {"c3d_proj/proj_c3d_W"} if key == "train:mp" else {
        "proj_out_W"}
    for rank in results_of(results, key):
        np.testing.assert_allclose(rank["loss"], losses, rtol=1e-5)
        np.testing.assert_allclose(rank["grad_norm"], norms, rtol=1e-5)
        got = rank["params"][0]
        assert split <= set(got) and set(got) == set(flats[0])
        for k in flats[0]:
            np.testing.assert_allclose(before[k] - got[k],
                                       before[k] - flats[0][k], **GRAD_TOL,
                                       err_msg=k)


def test_shard_batch_passes_a_rank_shard_through(world2):
    ranks = results_of(world2[1], "shard_batch")
    whole = np.arange(32.).reshape(8, 4)
    for r, rank in enumerate(ranks):
        assert rank["same_object"] and rank["passes_sliced"]
        assert rank["keys"] == ["x"]  # clipnames dropped
        np.testing.assert_array_equal(rank["rows"], whole[4 * r:4 * r + 4])
        np.testing.assert_array_equal(rank["sliced"],
                                      whole[4 * r:4 * r + 4])
        np.testing.assert_array_equal(rank["replicated"], np.zeros(3))


def test_sharded_predict_pads_a_tail_batch(world2):
    inputs, results, _ = world2
    spec = inputs["predict"]
    jmodel = jregistry.create_model(spec["name"], **spec["widths"])
    want = np.asarray(jmodel.predict(spec["params"],
                                     jnp.asarray(spec["frames"]),
                                     jnp.asarray(spec["c3d"])))
    for rank in results_of(results, "predict"):
        assert rank["maps"].shape[0] == 5
        np.testing.assert_allclose(rank["maps"], want, **MAP_TOL)
        # each rank loaded 2 of the first 4 rows: all 4 come back
        np.testing.assert_allclose(rank["host_local"], want[:4], **MAP_TOL)


def test_sharded_streaming_matches_jax(world2):
    inputs, results, _ = world2
    spec = inputs["stream"]
    jmodel = jregistry.create_model(spec["name"], **spec["widths"])
    feats = spec["feats"]
    state = jstreaming.init_stream_state(feats.shape[0], jmodel.cfg)
    chunks = []
    for start in range(0, feats.shape[1], spec["chunk"]):
        state, maps = jstreaming.grcn_stream_step(
            spec["params"], state,
            jnp.asarray(feats[:, start:start + spec["chunk"]]), jmodel.cfg)
        chunks.append(np.asarray(maps))
    want = np.concatenate(chunks, 1)
    for rank in results_of(results, "stream"):
        assert rank["local_state_rows"] == 2  # the state stays a shard
        np.testing.assert_allclose(rank["maps"], want, rtol=1e-4, atol=1e-5)


def test_sharded_fused_predict_matches_jax(world2):
    inputs, results, _ = world2
    spec = inputs["fused_predict"]
    jmodel = jregistry.create_model(spec["name"], **spec["widths"])
    want = np.asarray(jpipeline.extract_and_predict(
        {k: jnp.asarray(v) for k, v in spec["c3d"].items()}, spec["params"],
        jmodel, jnp.asarray(spec["video"]), compute_dtype=jnp.float32))
    for rank in results_of(results, "fused_predict"):
        assert rank["maps"].shape == want.shape  # 3 videos on 2 ranks
        np.testing.assert_allclose(rank["maps"], want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("finetune", [False, True])
def test_sharded_fused_train_step_matches_jax(world2, finetune):
    inputs, results, _ = world2
    spec = inputs[f"fused_train:{finetune}"]
    jmodel = jregistry.create_model(spec["name"], **spec["widths"])
    c3d = {k: jnp.asarray(v) for k, v in spec["c3d"].items()}
    jtx = j_build_optimizer(JOptCfg(**spec["opt"]), spec["params"])
    opt_state = jpipeline.init_fused_opt_state(
        jtx, spec["params"], c3d, c3d_tx=jtx, finetune_c3d=finetune)
    step = jpipeline.make_fused_train_step(
        jmodel, jtx, finetune_c3d=finetune, c3d_tx=jtx, use_flip=False,
        compute_dtype=jnp.float32, remat_c3d=False)
    gaze, _, c3d_new, m = step(
        spec["params"], opt_state, c3d,
        {k: jnp.asarray(v) for k, v in spec["batch"].items()},
        jax.random.PRNGKey(0))
    want = flatten_params(_np(gaze))
    for rank in results_of(results, f"fused_train:{finetune}"):
        assert abs(rank["loss"] - float(m["loss"])) <= \
            1e-5 * abs(float(m["loss"]))
        for k in want:
            np.testing.assert_allclose(rank["params"][k], want[k],
                                       rtol=1e-4, atol=1e-6, err_msg=k)
        moved = max(rank["c3d_moved"].values())
        assert (moved > 0) == finetune  # a frozen tower passes untouched
        if finetune:
            want_c3d = _np(c3d_new)
            assert set(rank["c3d"]) == set(want_c3d)
            for k, v in rank["c3d"].items():
                np.testing.assert_allclose(v, want_c3d[k], rtol=1e-4,
                                           atol=1e-6, err_msg=k)


def test_sharded_evaluate_matches_jax(world2):
    inputs, results, _ = world2
    spec = inputs["evaluate"]
    want = metrics_jax.evaluate_batch(
        jnp.asarray(spec["pred"]), jnp.asarray(spec["gt"]),
        jnp.asarray(spec["fixation"]), jax.random.PRNGKey(0),
        metrics=spec["metrics"], other_map=jnp.asarray(spec["other_map"]),
        exact=True)
    for rank in results_of(results, "evaluate"):
        for m in spec["metrics"]:
            assert rank[m].shape == (37,)
            np.testing.assert_allclose(rank[m], np.asarray(want[m]),
                                       **SCORE_TOL, err_msg=m)


def test_fit_on_mesh_resumes_across_topologies(world2, world4):
    """A one-process checkpoint resumed on 2 ranks and on 2x2 gives the
    losses of the one-process resume; a 2-rank checkpoint resumed in one
    process gives the losses of the 2-rank run that resumed the
    one-process checkpoint of the same step, and so does the 2x2 run past
    its cadences (which must leave the split weights as they were)."""
    _, results, dirs = world2
    want = _train_losses(dirs["one_resumed"])
    assert sorted(want) == [3, 4]
    runs = [results_of(results, "fit_run")[0]["rows"],
            results_of(world4[1], "fit_run")[0]["rows"]]
    for rows in (runs[0][0], runs[1][0]):
        got = _train_losses(rows)
        assert sorted(got)[:2] == [3, 4]
        np.testing.assert_allclose([got[s] for s in (3, 4)],
                                   [want[s] for s in (3, 4)],
                                   rtol=RESUME_RTOL)
        seen = {k for _, m in rows for k in m}
        assert "loss/val" in seen
        assert any(k.startswith("evaluation/") for k in seen)
    # every rank ran; rank 0 alone wrote
    assert all(r["rows"][0] == [] for r in results["fit_run"][1:])
    # 2-rank checkpoint (dir a, step 4) -> one process, against the 2-rank
    # run from the one-process step-4 checkpoint (dir c)
    back = _train_losses(_fit_one(dirs["a"], 6))
    control = _train_losses(runs[0][1])
    wide = _train_losses(runs[1][0])
    assert sorted(back) == sorted(control) == [5, 6]
    for got in (back, wide):
        np.testing.assert_allclose([got[s] for s in (5, 6)],
                                   [control[s] for s in (5, 6)],
                                   rtol=RESUME_RTOL)


def test_checkpoint_decisions_are_rank0s(world2):
    """Step 2 exists in rank 0's train_dir only: saving it again is
    skipped on both ranks, step 3 is written by rank 0 alone, and the
    restore of rank 0's latest step, which rank 1 cannot see, raises on
    both ranks; the ranks' collectives still pair up afterwards."""
    views = results_of(world2[1], "checkpoint_views")
    assert views[0]["steps"] == [["2"], ["2", "3"]]
    assert views[1]["steps"] == [[], []]
    for rank, view in enumerate(views):
        assert "is missing on some rank of the mesh" in view["raised"]
        assert ("does not see" in view["raised"]) == (rank == 1)
        assert view["after"] == 0


def test_cli_runs_under_a_two_rank_launch(world2, tmp_path):
    """`cli.train_gaze --data_parallel -1` trains on 2 ranks and writes
    once; `cli.evaluate_gaze --data_parallel 2` scores it split over the
    ranks, as one process scores it; `cli.train_fused --data_parallel 2`
    trains from pixels on the 2 ranks (`fit_fused`'s mesh branch)."""
    _, results, dirs = world2
    for rank in results_of(results, "cli"):
        assert rank["rcs"] == [0, 0, 0]
    run = dirs["cli"]
    assert sorted(os.listdir(os.path.join(run, "model"))) == ["2"]
    fused_run = os.path.join(os.path.dirname(run), "fused_run")
    assert sorted(os.listdir(os.path.join(fused_run, "model"))) == ["2"]
    with open(os.path.join(run, "evaluation", "overall.txt")) as f:
        sharded = f.read()
    out = str(tmp_path / "one")
    assert evaluate_gaze.main(["--train_dir", run, "--device", "cpu",
                               "--out_dir", out, "--metrics", "cc", "sim",
                               "nss"]) == 0
    with open(os.path.join(out, "overall.txt")) as f:
        one = f.read()
    parse = lambda s: {k: float(v) for k, v in  # noqa: E731
                       (line.split(": ") for line in s.splitlines())}
    assert parse(sharded).keys() == parse(one).keys()
    for k, v in parse(one).items():
        assert parse(sharded)[k] == pytest.approx(v, rel=1e-5, abs=1e-6)


@pytest.mark.parametrize("name,widths", [
    ("gaze_grcn", dict(dim_cnn_proj=512, rnn_state_size=8)),
    ("gaze_rnn", {}),
    ("gaze_grcn_cascade", {}),
    ("gaze_pupil_gru2", {}),
])
def test_layouts_match_jax(name, widths):
    """`params_shardings` / `state_shardings` (a 2x2 layout) and
    `batch_spec` give each leaf the JAX package's PartitionSpec, and
    `host_local_slice` its rows."""
    from recurrent_gaze_prediction_tpu import parallel as jparallel
    from recurrent_gaze_prediction_tpu.train.state import (
        create_train_state as j_create_train_state)
    from recurrent_gaze_prediction_tpu_torch.bridge import jax_name
    from recurrent_gaze_prediction_tpu_torch.config import OptimizerConfig

    jmodel = jregistry.create_model(name, **widths)
    jstate, _ = j_create_train_state(jmodel, JOptCfg(),
                                     jax.random.PRNGKey(0))
    jmesh = jparallel.make_mesh(2, 2)
    jspecs = flatten_params(jax.tree_util.tree_map(
        lambda sh: tuple(sh.spec), jparallel.params_shardings(
            jstate.params, jmesh),
        is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding)))
    model = registry.create_model(name, device="cpu", **widths)
    state, _ = create_train_state(model, OptimizerConfig())
    mesh = parallel.Mesh(2, 2, 0, torch.device("cpu"), None, None)
    specs = parallel.params_shardings(state.params, mesh)
    got = {jax_name(n): spec for n, spec in specs.items()}
    assert got.keys() == jspecs.keys()
    for k, spec in got.items():
        # a replicated leaf is P() in JAX, () here
        assert spec == tuple(jspecs[k]), k
    assert any("model" in spec for spec in got.values())
    moments = parallel.state_shardings(state, mesh).opt_state["mu"]
    assert moments == {n: specs[n] for n in moments}
    assert parallel.batch_spec() == tuple(jparallel.batch_spec())
    for pi, pc in ((0, 2), (1, 2), (3, 4)):
        assert parallel.host_local_slice(8, pi, pc) == \
            jparallel.host_local_slice(8, pi, pc)


def test_make_mesh_errors_and_hybrid_fallback(monkeypatch):
    """Without a launch this process is a world of one: a larger mesh
    raises the JAX package's message before any group starts, and so
    does one that leaves ranks out; the hybrid mesh on one host falls
    back to the flat one."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"):
        parallel.make_mesh(2, 1)
    with pytest.raises(ValueError, match="mesh 1x2 needs 2 devices, have 1"):
        parallel.make_mesh(1, 2, devices=["cpu"])
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="covers 2 of the job's 4 ranks"):
        parallel.make_mesh(2, 1, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="needs 8 devices, have 4"):
        parallel.make_hybrid_mesh(2, 4)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="does not match the job's 2 hosts"):
        parallel.make_hybrid_mesh(4, 1)
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    mesh = parallel.make_hybrid_mesh(1, -1, 1, devices=["cpu"])  # flat
    try:
        assert mesh.shape == {"data": 1, "model": 1}
        assert mesh.data_group is None and mesh.model_group is None
        assert parallel.params_shardings(
            {"c3d_proj.proj_c3d_W": torch.zeros(4, 6),
             "cell.W_z": torch.zeros(4, 6)}, mesh, model_parallel=True) == {
            "c3d_proj.proj_c3d_W": (None, "model"), "cell.W_z": ()}
        assert parallel.batch_spec() == ("data",)
        assert parallel.host_local_slice(8, 1, 2) == slice(4, 8)
        with pytest.raises(ValueError, match="not divisible by 3"):
            parallel.host_local_slice(8, 0, 3)
    finally:
        torch.distributed.destroy_process_group()
