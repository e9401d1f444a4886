"""The port's `cli.extract_features` and `cli.extract_map` against the JAX
package's CLIs on the CPU, on the same files and the same weights.

  * extract_features on the JAX tests' .avi (`tests/test_streaming.py`:
    36 frames of 48x64, so two full windows and a zero-padded tail), f32,
    the same He-scaled C3D weights from one .npz: the `.c3d` contents at
    rtol 1e-4 / atol 1e-5, plain and gaze-weighted (`--attention_maps_root`);
  * extract_map, batched and `--streaming`, for gaze_grcn and gaze_lstm,
    from two run dirs holding the same parameters (an orbax checkpoint for
    the JAX CLI, the port's for the port's): the saved float16 maps and
    their 7x7 poolings within one float16 ulp.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from recurrent_gaze_prediction_tpu import registry as jregistry
from recurrent_gaze_prediction_tpu.cli import extract_features as jextract
from recurrent_gaze_prediction_tpu.cli import extract_map as jmap
from recurrent_gaze_prediction_tpu.config import (
    ExperimentConfig as JExperimentConfig)
from recurrent_gaze_prediction_tpu.train import Checkpointer as JCheckpointer
from recurrent_gaze_prediction_tpu.train import (
    create_train_state as jcreate_train_state)
from recurrent_gaze_prediction_tpu_torch import registry
from recurrent_gaze_prediction_tpu_torch.bridge import params_from_jax
from recurrent_gaze_prediction_tpu_torch.cli import extract_features
from recurrent_gaze_prediction_tpu_torch.cli import extract_map
from recurrent_gaze_prediction_tpu_torch.config import ExperimentConfig
from recurrent_gaze_prediction_tpu_torch.data import codec
from recurrent_gaze_prediction_tpu_torch.train import (Checkpointer,
                                                       create_train_state)
from test_torch_c3d import jax_c3d_params

CPU = ["--device", "cpu"]


def _write_avi(path, n_frames=36, h=48, w=64):
    """`tests/test_streaming.py::_write_avi`: a red bar that moves."""
    cv2 = pytest.importorskip("cv2")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10,
                             (w, h))
    assert writer.isOpened()
    for i in range(n_frames):
        frame = np.zeros((h, w, 3), np.uint8)
        frame[:, (2 * i) % w:(2 * i) % w + 6] = (0, 0, 255)  # BGR: red bar
        writer.write(frame)
    writer.release()
    return path


@pytest.fixture(scope="module")
def video_and_weights(tmp_path_factory):
    base = tmp_path_factory.mktemp("extract")
    videos = base / "videos"
    videos.mkdir()
    _write_avi(str(videos / "clip.avi"))
    params = jax_c3d_params(seed=7, fc=False)
    # conv5b O(1): the frames enter at 0..255
    params["conv1a_w"] = params["conv1a_w"] / 128.0
    npz = str(base / "c3d.npz")
    np.savez(npz, **params)
    maps = base / "maps"
    maps.mkdir()
    np.save(maps / "clip.gazemap.npy", np.random.RandomState(8).rand(
        5, 49, 49).astype(np.float16))
    return base, str(videos), npz, str(maps)


@pytest.mark.parametrize("attention", [False, True])
def test_extract_features_matches_jax(video_and_weights, attention):
    base, videos, npz, maps = video_and_weights
    tag = "att" if attention else "plain"
    out = {}
    for name, main, extra in (("port", extract_features.main, CPU),
                              ("jax", jextract.main, [])):
        out[name] = str(base / f"{name}_{tag}")
        args = ["--videos_root", videos, "--out_dir", out[name], "--params",
                npz, "--compute_dtype", "float32", "--batch_windows", "2"]
        if attention:
            args += ["--attention_maps_root", maps]
        assert main(args + extra) == 0
    got = codec.read_c3d_file(os.path.join(out["port"], "clip.c3d"))
    want = codec.read_c3d_file(os.path.join(out["jax"], "clip.c3d"))
    assert got.shape == want.shape == (3, 512, 2, 7, 7)
    assert np.abs(want).max() > 0.1  # the tower did not die out
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_extract_features_skips_and_fails_like_jax(video_and_weights,
                                                   tmp_path):
    base, videos, npz, _ = video_and_weights
    (tmp_path / "broken.avi").write_bytes(b"not a video")
    for main, extra in ((extract_features.main, CPU), (jextract.main, [])):
        out = str(tmp_path / f"out{len(extra)}")
        args = ["--videos", os.path.join(videos, "clip.avi"),
                str(tmp_path / "broken.avi"), "--out_dir", out, "--params",
                npz, "--compute_dtype", "float32"]
        assert main(args + extra) == 1          # the broken video failed
        assert os.listdir(out) == ["clip.c3d"]
        assert main(args[:2] + args[3:] + extra) == 0  # skipped: exists
        assert main(["--out_dir", out] + extra) == 1   # no videos


def test_extract_windows_pipelines_chunks(video_and_weights):
    """The window loop at every chunking: 1..4 chunks in flight, batches
    of 1..3 windows, give the same blobs (the staging ring refills no
    buffer before its chunk was read)."""
    _, videos, npz, _ = video_and_weights
    with np.load(npz) as blob:
        from recurrent_gaze_prediction_tpu_torch.bridge import (
            c3d_params_from_jax)
        params = c3d_params_from_jax(dict(blob))
    frames = np.random.RandomState(9).randint(0, 256, (70, 20, 24, 3),
                                              np.uint8)
    ref = extract_features.extract_windows(
        params, frames, compute_dtype="float32", batch_windows=5,
        device="cpu")
    assert len(ref) == 5 and ref[0].shape == (512, 2, 7, 7)
    for batch, inflight in ((1, 1), (2, 4), (3, 2)):
        got = extract_features.extract_windows(
            params, frames, compute_dtype="float32", batch_windows=batch,
            max_inflight_chunks=inflight, device="cpu")
        # other batch sizes sum in other orders: the tower's tolerance
        np.testing.assert_allclose(np.stack(got), np.stack(ref), rtol=1e-4,
                                   atol=1e-5)


def test_blob_layout_and_attention_index_match_jax():
    feats = np.random.RandomState(10).rand(2, 7, 7, 512).astype(np.float32)
    np.testing.assert_array_equal(
        extract_features.blob_layout(np.transpose(feats, (3, 0, 1, 2))),
        jextract._blob_layout(feats, "conv5b"))
    flat = np.arange(4096, dtype=np.float32)
    np.testing.assert_array_equal(extract_features.blob_layout(flat),
                                  jextract._blob_layout(flat, "fc6"))
    for n_frames, n_maps in ((36, 5), (100, 3), (10, 40)):
        np.testing.assert_array_equal(
            extract_features.attention_frame_index(n_frames, n_maps),
            jextract.attention_frame_index(n_frames, n_maps))


# ------------------------------------------------------------ extract_map

WIDTHS = dict(dim_cnn_proj=8, rnn_state_size=8, compute_dtype="float32")


def _run_dirs(base, name, seed=0, out_scale=1.0, **overrides):
    """A JAX run dir and a port run dir with the same parameters (WIDTHS,
    then `overrides` of the model config): the JAX package's init with
    the cell weights redrawn (x0.3) so the recurrence matters, carried
    across by the bridge. `out_scale` multiplies the decoder's output
    weights: the init's maps are nearly flat, which z-scoring metrics
    amplify f32 noise of."""
    exp = JExperimentConfig()
    exp.model.name = name
    for key, value in {**WIDTHS, **overrides}.items():
        setattr(exp.model, key, value)
    jmodel = jregistry.create_model(name, exp.model)
    state, _ = jcreate_train_state(jmodel, exp.optimizer,
                                   jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    state.params["cell"] = {
        k: jnp.asarray(rng.randn(*v.shape).astype(np.float32) * 0.3)
        for k, v in state.params["cell"].items()}
    state.params["decoder"]["out_W"] = state.params["decoder"]["out_W"] \
        * out_scale
    jdir = str(base / f"jax_{name}")
    ckpt = JCheckpointer(jdir)
    ckpt.save(state, wait=True)
    ckpt.save_config(exp)
    ckpt.close()

    texp = ExperimentConfig.load(os.path.join(jdir, "config.json"))
    model = registry.create_model(name, texp.model, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, state.params)))
    tstate, _ = create_train_state(model, texp.optimizer)
    tdir = str(base / f"port_{name}")
    tckpt = Checkpointer(tdir)
    tckpt.save(tstate)
    tckpt.save_config(texp)
    return jdir, tdir


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Three clip folders: 30 frame files, none, and 12 (fewer than 16:
    the [15::5] subsample is empty); `.c3d` files of 11, 3 and 1 windows."""
    from PIL import Image

    base = tmp_path_factory.mktemp("clips")
    rng = np.random.RandomState(11)
    for name, n_frames, n_windows in (("clipA", 30, 11), ("clipB", 0, 3),
                                      ("clipC", 12, 1)):
        (base / name).mkdir()
        for i in range(n_frames):
            Image.fromarray(rng.randint(0, 255, (40, 40, 3)).astype(
                np.uint8)).save(base / name / f"{i:04d}.jpg")
        codec.write_c3d_file(str(base / f"{name}.c3d"), list(
            rng.rand(n_windows, 1, 512, 2, 7, 7).astype(np.float32)))
    return base


def _assert_maps_match(got_dir, want_dir, clip_names):
    for clip in clip_names:
        for suffix in (".gazemap.npy", ".gazemap7x7.npy"):
            got = np.load(os.path.join(got_dir, clip + suffix))
            want = np.load(os.path.join(want_dir, clip + suffix))
            assert got.dtype == want.dtype == np.float16
            assert got.shape == want.shape
            # one float16 ulp of the larger magnitude
            ulp = np.spacing(np.maximum(np.abs(got), np.abs(want)))
            assert (np.abs(got.astype(np.float32) - want.astype(np.float32))
                    <= ulp.astype(np.float32)).all(), clip + suffix


@pytest.mark.parametrize("name", ["gaze_grcn", "gaze_lstm"])
@pytest.mark.parametrize("streaming", [False, True])
def test_extract_map_matches_jax(tmp_path, clips, name, streaming):
    jdir, tdir = _run_dirs(tmp_path, name)
    args = ["--clips_root", str(clips), "--n_lstm_steps", "8",
            "--batch_size", "2"]
    if streaming:
        args += ["--streaming", "--chunk_len", "4"]
    out = {}
    for tag, main, run, extra in (("port", extract_map.main, tdir, CPU),
                                  ("jax", jmap.main, jdir, [])):
        out[tag] = str(tmp_path / f"maps_{tag}")
        assert main(["--train_dir", run, "--out_dir", out[tag]] + args
                    + extra) == 0
    clip_names = ["clipA", "clipB", "clipC"]
    _assert_maps_match(out["port"], out["jax"], clip_names)
    lengths = [len(np.load(os.path.join(out["port"], c + ".gazemap.npy")))
               for c in clip_names]
    # batched: truncated to n_lstm_steps and to the frames ([15::5] of 30
    # frames is 3; a folder with no frames gives one zero frame; 12 frames
    # give none, so one zero frame); streamed: every window of the clip
    assert lengths == ([11, 3, 1] if streaming else [3, 1, 1])


def test_extract_map_refusals_and_helpers(tmp_path, clips):
    _, tdir = _run_dirs(tmp_path, "gaze_grcn")
    # the mesh is ported: in this one-rank world a mesh of 2 raises the
    # JAX package's error (multi-rank: tests/test_torch_parallel.py)
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices"):
        extract_map.main(["--train_dir", tdir, "--clips_root", str(clips),
                          "--out_dir", str(tmp_path / "m"),
                          "--data_parallel", "2"] + CPU)
    empty = tmp_path / "no_checkpoint"
    empty.mkdir()
    ExperimentConfig().dump(str(empty / "config.json"))
    assert extract_map.main(["--train_dir", str(empty), "--clips_root",
                             str(clips), "--out_dir", str(tmp_path / "m")]
                            + CPU) == 1
    maps = np.random.RandomState(12).rand(3, 49, 49).astype(np.float32)
    np.testing.assert_array_equal(extract_map.avg_pool_7x7(maps),
                                  jmap.avg_pool_7x7(maps))
    for t in (2, 3, 5):
        np.testing.assert_array_equal(extract_map.pad_or_clip(maps, t),
                                      jmap.pad_or_clip(maps, t))
