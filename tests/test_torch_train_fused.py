"""Training from raw video: the port's fused train step against the JAX
package's on the CPU in f32 (the full C3D tower, narrow gaze widths,
dropout keep 1.0 and flip off so neither package draws), the synthetic
raw-video corpus, the video corpus loader (`load_fused_corpus`: the JAX
tests' .avi + gaze .mat fixtures, arrays equal to the JAX package's),
fused checkpoints, and `cli.train_fused` (synthetic and `--dataset
videos`).

The loss is held within 1e-5 (relative), the gradients at rtol 1e-3 /
atol 1e-5 (the JAX package's gradient tolerance), the parameters after one
SGD update at rtol 1e-4 / atol 1e-6, and gradient accumulation against the
full batch at rtol 1e-5.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recurrent_gaze_prediction_tpu import registry as jregistry
from recurrent_gaze_prediction_tpu.config import OptimizerConfig as JOptCfg
from recurrent_gaze_prediction_tpu.models import c3d as jc3d
from recurrent_gaze_prediction_tpu.models import pipeline as jpipeline
from recurrent_gaze_prediction_tpu.train import fused as jfused
from recurrent_gaze_prediction_tpu.train.state import (
    build_optimizer as j_build_optimizer)
from recurrent_gaze_prediction_tpu_torch import registry
from recurrent_gaze_prediction_tpu_torch.bridge import (
    c3d_params_from_jax, c3d_params_to_jax, flatten_params, jax_name,
    params_from_jax)
from recurrent_gaze_prediction_tpu_torch.cli import train_fused
from recurrent_gaze_prediction_tpu_torch.config import OptimizerConfig
from recurrent_gaze_prediction_tpu_torch.models import pipeline
from recurrent_gaze_prediction_tpu_torch.train import (
    Checkpointer, FusedTrainState, create_train_state, fused)
from test_torch_c3d import jax_c3d_params

WIDTHS = dict(dim_cnn_proj=32, rnn_state_size=16, compute_dtype="float32",
              dropout_keep_prob=1.0, use_flip_batch=False)
SGD = dict(method="sgd", initial_learning_rate=1e-3)


def _positive_tower(seed: int) -> dict:
    """C3D weights (JAX layout) under which every pre-activation is
    positive and O(1): |N(0,1)| weights normalized so each conv averages
    its inputs, and conv1a's bias lifts the mean-subtracted pixels
    (-101..154) above zero. No ReLU then sits near zero, where the two
    packages' f32 summation orders flip it: through eight layers such
    flips move the tower's gradients by ~1e-3..1e-2, while its activations
    agree to ~1e-6."""
    params = jax_c3d_params(seed, fc=False)
    rng = np.random.RandomState(seed + 100)
    in_ch = 3
    for name, out_ch in jc3d.CONV_LAYERS:
        w = np.abs(rng.randn(3, 3, 3, in_ch, out_ch)) / (27 * in_ch * 0.7979)
        b = 0.1 + 0.1 * rng.rand(out_ch)
        if name == "conv1a":
            w, b = w / 100.0, b + 2.0
        params[f"{name}_w"] = w.astype(np.float32)
        params[f"{name}_b"] = b.astype(np.float32)
        in_ch = out_ch
    return params


def _setup(t: int, seed: int = 0, positive: bool = False):
    """JAX and port gaze models with the same random weights (the cell at
    x0.3), and the C3D weights in both layouts: He-scaled with conv1a
    scaled so conv5b is O(1), as in test_torch_pipeline.py, or
    `_positive_tower`'s."""
    jmodel = jregistry.create_model("gaze_grcn", n_lstm_steps=t, **WIDTHS)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    jparams["cell"] = {k: jnp.asarray(rng.randn(*v.shape).astype(np.float32)
                                      * 0.3)
                       for k, v in jparams["cell"].items()}
    tmodel = registry.create_model("gaze_grcn", n_lstm_steps=t, device="cpu",
                                   **WIDTHS)
    tmodel.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams)))
    if positive:
        c3d = _positive_tower(seed + 1)
    else:
        c3d = jax_c3d_params(seed=seed + 1, fc=False)
        c3d["conv1a_w"] = c3d["conv1a_w"] / 128.0
    return (jmodel, jparams, {k: jnp.asarray(v) for k, v in c3d.items()},
            tmodel, c3d_params_from_jax(c3d))


def _batch(b: int, f: int, seed: int = 7) -> dict:
    rng = np.random.RandomState(seed)
    t = pipeline.pipeline_timesteps(f)
    return {"video": rng.randint(0, 256, (b, f, 128, 171, 3)).astype(
                np.uint8),
            "gazemaps": np.abs(rng.randn(b, t, 49, 49)).astype(np.float32)}


def _assert_tree_close(port: dict, jax_flat: dict, **tol):
    assert set(port) == set(jax_flat)
    for k in port:
        np.testing.assert_allclose(port[k], jax_flat[k], err_msg=k, **tol)


@pytest.mark.parametrize("finetune,f", [(False, 32), (True, 16)])
def test_fused_train_step_matches_jax(finetune, f):
    t = pipeline.pipeline_timesteps(f)
    jmodel, jparams, jc3d, tmodel, tc3d = _setup(t, positive=finetune)
    batch = _batch(2, f)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    # the gradients without remat (the train step below remats the tower
    # when it is fine-tuned)
    jloss_fn = jpipeline.make_fused_loss_fn(jmodel,
                                            compute_dtype=jnp.float32)
    jloss, jgrads = jpipeline.make_fused_grads_fn(
        jloss_fn, finetune_c3d=finetune)(jparams, jc3d, jbatch,
                                          jax.random.PRNGKey(0))
    jtx = j_build_optimizer(JOptCfg(**SGD), jparams)
    jg_gaze = jgrads[0] if finetune else jgrads
    updates, _ = jtx.update(jg_gaze, jtx.init(jparams), jparams)
    j_new = flatten_params(jax.tree_util.tree_map(
        np.asarray, optax.apply_updates(jparams, updates)))

    tloss_fn = pipeline.make_fused_loss_fn(tmodel, compute_dtype=None)
    tparams = dict(tmodel.named_parameters())
    tloss, tgrads = pipeline.make_fused_grads_fn(
        tloss_fn, finetune_c3d=finetune)(tparams, tc3d, tbatch, None)
    tg_gaze = tgrads[0] if finetune else tgrads
    assert tmodel.last_route == "kernel"  # B1/B2's plain versions here
    assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    _assert_tree_close(
        {jax_name(k): v.numpy() for k, v in tg_gaze.items()},
        flatten_params(jax.tree_util.tree_map(np.asarray, jg_gaze)),
        rtol=1e-3, atol=1e-5)
    if finetune:
        _assert_tree_close(
            c3d_params_to_jax(tgrads[1]),
            {k: np.asarray(v) for k, v in jgrads[1].items()},
            rtol=1e-3, atol=1e-5)

    # one SGD step through the port's train step, from the same weights
    state, tx = create_train_state(tmodel, OptimizerConfig(**SGD))
    state = FusedTrainState(
        params=state.params, c3d_params=tc3d,
        opt_state=pipeline.init_fused_opt_state(
            tx, state.params, tc3d, finetune_c3d=finetune))
    c3d_before = {k: v.clone() for k, v in tc3d.items()}
    step = pipeline.make_fused_train_step(tmodel, tx, finetune_c3d=finetune,
                                          compute_dtype=None)
    state, metrics = step(state, tbatch)
    assert metrics["step"] == state.step == 1
    _assert_tree_close(
        {jax_name(k): v.detach().numpy() for k, v in state.params.items()},
        j_new, rtol=1e-4, atol=1e-6)
    changed = not torch.equal(state.c3d_params["conv1a_w"],
                              c3d_before["conv1a_w"])
    assert changed == finetune


def test_accumulated_gradients_match_the_full_batch():
    _, _, _, tmodel, tc3d = _setup(1)
    tbatch = {k: torch.from_numpy(v) for k, v in _batch(2, 16).items()}
    loss_fn = pipeline.make_fused_loss_fn(tmodel, compute_dtype=None)
    tparams = dict(tmodel.named_parameters())
    full = pipeline.make_fused_grads_fn(loss_fn, finetune_c3d=False)(
        tparams, tc3d, tbatch, None)
    accum = pipeline.make_fused_grads_fn(loss_fn, finetune_c3d=False,
                                         accum_steps=2)(
        tparams, tc3d, tbatch, None)
    np.testing.assert_allclose(float(accum[0]), float(full[0]), rtol=1e-5)
    for k in full[1]:
        np.testing.assert_allclose(accum[1][k].numpy(), full[1][k].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("mode", ["bright", "flicker", "period"])
def test_synthetic_fused_corpus_equals_the_jax_package(mode):
    kw = dict(num_frames=32, frame_hw=(48, 64), gazemap_hw=(49, 49), seed=3,
              mode=mode)
    ours = fused.make_synthetic_fused_corpus(3, **kw)
    theirs = jfused.make_synthetic_fused_corpus(3, **kw)
    np.testing.assert_array_equal(ours.video, theirs.video)
    np.testing.assert_array_equal(ours.gazemaps, theirs.gazemaps)
    assert ours.clipnames == theirs.clipnames
    assert ours.video.dtype == np.uint8 and ours.gazemaps.shape[1] == 2


def test_fused_checkpoint_holds_both_trees_and_both_optimizer_states(
        tmp_path):
    model = registry.create_model("gaze_grcn", device="cpu", dim_feature=16,
                                  dim_cnn_proj=8, rnn_state_size=8,
                                  compute_dtype="float32")
    gaze, tx = create_train_state(model, OptimizerConfig())
    tower = {"conv1a_w": torch.randn(4, 3, 3, 3, 3), "conv1a_b": torch.ones(4)}
    opt = pipeline.init_fused_opt_state(tx, gaze.params, tower,
                                        finetune_c3d=True)
    opt[1]["mu"]["conv1a_w"].fill_(2.0)
    opt[1]["count"] = 5
    state = FusedTrainState(params=gaze.params, opt_state=opt,
                            c3d_params=tower, step=5)
    Checkpointer(str(tmp_path)).save(state)

    fresh_gaze, _ = create_train_state(registry.create_model(
        "gaze_grcn", device="cpu", dim_feature=16, dim_cnn_proj=8,
        rnn_state_size=8, compute_dtype="float32",
        generator=torch.Generator().manual_seed(9)), OptimizerConfig())
    fresh_tower = {k: torch.zeros_like(v) for k, v in tower.items()}
    fresh = FusedTrainState(
        params=fresh_gaze.params, c3d_params=fresh_tower,
        opt_state=pipeline.init_fused_opt_state(
            tx, fresh_gaze.params, fresh_tower, finetune_c3d=True))
    assert Checkpointer(str(tmp_path)).restore_latest(fresh) is fresh
    assert fresh.step == 5 and fresh.opt_state[1]["count"] == 5
    for k, v in tower.items():
        assert torch.equal(fresh.c3d_params[k], v)
    assert bool((fresh.opt_state[1]["mu"]["conv1a_w"] == 2.0).all())
    for k, v in gaze.params.items():
        assert torch.equal(fresh.params[k], v)
    # a frozen run's single optimizer state does not restore into the pair
    frozen = FusedTrainState(params=fresh_gaze.params,
                             c3d_params=fresh_tower,
                             opt_state=tx.init(fresh_gaze.params))
    with pytest.raises(ValueError, match="optimizer states"):
        Checkpointer(str(tmp_path)).restore_latest(frozen)


def _records(run):
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cli_train_fused_steps_checkpoints_and_resumes(tmp_path):
    run = str(tmp_path / "run")
    argv = ["--device", "cpu", "--dataset", "synthetic", "--num_frames",
            "16", "--batch_size", "2", "--synthetic_clips", "2",
            "--compute_dtype", "float32", "--steps_per_logprint", "1",
            "--train_dir", run]
    assert train_fused.main(argv + ["--max_steps", "2"]) == 0
    assert Checkpointer(run).steps() == [2]
    assert [r["step"] for r in _records(run)] == [1, 2]
    assert all(np.isfinite(r["loss/train"]) for r in _records(run))
    cfg = Checkpointer.load_config(run)
    assert (cfg.model.n_lstm_steps, cfg.model.batch_size) == (1, 2)
    saved = torch.load(os.path.join(run, "model", "2", "state.pt"),
                       weights_only=True)
    assert saved["c3d_params"]["conv1a_w"].shape == (64, 3, 3, 3, 3)

    assert train_fused.main(argv + ["--max_steps", "3"]) == 0
    assert Checkpointer(run).steps() == [2, 3]
    assert [r["step"] for r in _records(run)] == [1, 2, 3]


@pytest.mark.parametrize("freeze", [True, False])
def test_cli_train_fused_grafts_a_pretrained_shallownet(tmp_path, freeze):
    """`--shallownet_pretrain` grafts a params file into
    gaze_framewise_shallownet before training from pixels (the frame
    stream feeds it); with `--freeze_shallownet` it is still the file's
    after a step, without it it trains (the JAX fused trainer's rule)."""
    from recurrent_gaze_prediction_tpu_torch.models import shallownet
    from recurrent_gaze_prediction_tpu_torch.train import save_params

    pretrained = shallownet.init_params(
        generator=torch.Generator().manual_seed(5))
    path = str(tmp_path / "sn.pt")
    save_params(path, pretrained)
    run = str(tmp_path / "run")
    argv = ["--device", "cpu", "--dataset", "synthetic", "--model",
            "gaze_framewise_shallownet", "--num_frames", "16",
            "--batch_size", "2", "--synthetic_clips", "2",
            "--compute_dtype", "float32", "--max_steps", "1",
            "--shallownet_pretrain", path, "--train_dir", run]
    assert train_fused.main(argv + (["--freeze_shallownet"] if freeze
                                    else [])) == 0
    saved = torch.load(os.path.join(run, "model", "1", "state.pt"),
                       weights_only=True)["params"]
    same = [torch.equal(saved[f"shallownet/{k}"], v)
            for k, v in pretrained.items()]
    assert all(same) if freeze else not any(
        same[i] for i, k in enumerate(pretrained) if k.endswith("_w"))


@pytest.mark.parametrize("flags,error", [
    (["--dataset", "synthetic", "--model_parallel", "2"],
     "mesh 1x2 needs 2 devices, have 1"),
    (["--dataset", "synthetic", "--data_parallel", "2"],
     "mesh 2x1 needs 2 devices, have 1"),
])
def test_cli_train_fused_refuses_what_is_not_ported(flags, error):
    """The mesh flags are ported: in this one-rank world a larger mesh
    raises the JAX package's error (multi-rank runs:
    tests/test_torch_parallel.py)."""
    with pytest.raises(ValueError, match=error):
        train_fused.main(["--device", "cpu"] + flags)


F = 32  # the JAX tests' clip length: two C3D windows, T = 2


def _avi(path, n_frames, rng, oh=36, ow=48):
    cv2 = pytest.importorskip("cv2")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10,
                             (ow, oh))
    assert writer.isOpened()
    for _ in range(n_frames):
        writer.write(rng.randint(0, 255, (oh, ow, 3), np.uint8))
    writer.release()


@pytest.fixture(scope="module")
def video_corpus(tmp_path_factory):
    """`tests/test_train_fused.py::test_load_fused_corpus_from_avi`'s
    fixture: two .avi clips of F + 8 frames (36x48) with raw gaze .mat
    records of two users each, processed by `cli.process_gazemap`."""
    import h5py

    from recurrent_gaze_prediction_tpu_torch.cli import process_gazemap

    base = tmp_path_factory.mktemp("corpus")
    videos, gaze = base / "videos", base / "gazemap"
    videos.mkdir()
    gaze.mkdir()
    rng = np.random.RandomState(0)
    oh, ow = 36, 48
    for ci in range(2):
        clip = f"clip{ci:03d}"
        _avi(str(videos / (clip + ".avi")), F + 8, rng, oh, ow)
        with h5py.File(gaze / (clip + ".mat"), "w") as mat:
            grp = mat.create_group("data")
            for ui in range(2):
                user = grp.create_group(f"user{ui:02d}")
                raw = np.zeros((F + 8, oh, ow), np.uint8)
                raw[np.arange(F + 8), rng.randint(0, oh, F + 8),
                    rng.randint(0, ow, F + 8)] = 1
                user["gazemap"] = raw
                user["pupilsize"] = rng.rand(F + 8)
    assert process_gazemap.main(["--glob", str(gaze / "*.mat"),
                                 "--num_agents", "1"]) == 0
    return str(videos), str(gaze)


def _assert_same_corpus(got, want):
    assert got.clipnames == want.clipnames
    assert got.video.dtype == want.video.dtype == np.uint8
    np.testing.assert_array_equal(got.video, want.video)
    np.testing.assert_array_equal(got.gazemaps, want.gazemaps)


def test_load_fused_corpus_from_avi(video_corpus):
    videos, gaze = video_corpus
    got = fused.load_fused_corpus(videos, gaze, num_frames=F,
                                  frame_hw=(40, 56))
    want = jfused.load_fused_corpus(videos, gaze, num_frames=F,
                                    frame_hw=(40, 56))
    t = pipeline.pipeline_timesteps(F)
    assert got.video.shape == (2, F, 40, 56, 3)
    assert got.gazemaps.shape == (2, t, 49, 49)
    assert got.gazemaps.min() > 0  # blurred and floored
    _assert_same_corpus(got, want)


def test_load_fused_corpus_missing_inputs(tmp_path):
    for load in (fused.load_fused_corpus, jfused.load_fused_corpus):
        with pytest.raises(ValueError, match="no videos"):
            load(str(tmp_path), str(tmp_path), num_frames=F)


def test_load_fused_corpus_skips_allzero_gaze(tmp_path):
    """A clip whose gaze record is all-zero for every user is skipped with
    a warning, as the JAX package does; so is a clip without a record."""
    import h5py

    videos, gaze = tmp_path / "videos", tmp_path / "gazemap"
    videos.mkdir()
    gaze.mkdir()
    rng = np.random.RandomState(0)
    for ci, zero in enumerate([False, True, None]):
        clip = f"clip{ci:03d}"
        _avi(str(videos / (clip + ".avi")), F, rng)
        if zero is None:
            continue  # no gaze record
        with h5py.File(gaze / (clip + ".mat"), "w") as mat:
            user = mat.create_group("data").create_group("user00")
            maps = np.zeros((F, 49, 49), np.float32)
            if not zero:
                maps[np.arange(F), rng.randint(0, 49, F),
                     rng.randint(0, 49, F)] = 1.0
            user["gazemap49x49"] = maps
    got = fused.load_fused_corpus(str(videos), str(gaze), num_frames=F,
                                  frame_hw=(40, 56))
    want = jfused.load_fused_corpus(str(videos), str(gaze), num_frames=F,
                                    frame_hw=(40, 56))
    assert got.clipnames == ["clip000"]
    _assert_same_corpus(got, want)


@pytest.mark.parametrize("hw", [(20, 28), (40, 56), (36, 48)])
def test_resize_uint8_fallback_without_cv2(monkeypatch, hw):
    """Without cv2 both packages fall back to a bilinear resize that
    antialiases when it shrinks (`jax.image.resize`, here
    `ops.layers.resize_bilinear`): within one uint8 step of the JAX
    package's, shrinking, growing and at the frame's own size."""
    import sys

    frame = np.random.RandomState(3).randint(0, 256, (36, 48, 3)).astype(
        np.uint8)
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 -> ImportError
    got = fused._resize_uint8(frame, *hw)
    want = jfused._resize_uint8(frame, *hw)
    assert got.dtype == want.dtype == np.uint8 and got.shape == (*hw, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("roots", [False, True])
def test_cli_train_fused_on_videos(tmp_path, video_corpus, roots):
    """`--dataset videos` without both roots fails as the JAX CLI does
    (return 1); with them it trains on the corpus (frames resized on the
    host to 128x171) and checkpoints."""
    videos, gaze = video_corpus
    argv = ["--device", "cpu", "--dataset", "videos", "--num_frames",
            str(F), "--batch_size", "2", "--compute_dtype", "float32",
            "--max_steps", "1", "--steps_per_logprint", "1", "--train_dir",
            str(tmp_path / "run")]
    if not roots:
        assert train_fused.main(argv + ["--videos_root", videos]) == 1
        assert not os.path.exists(tmp_path / "run")
        return
    assert train_fused.main(
        argv + ["--videos_root", videos, "--gaze_root", gaze]) == 0
    records = _records(str(tmp_path / "run"))
    assert [r["step"] for r in records] == [1]
    assert np.isfinite(records[0]["loss/train"])
    assert Checkpointer(str(tmp_path / "run")).steps() == [1]
