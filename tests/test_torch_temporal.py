"""Window (temporal) sharding of raw video (`parallel/temporal.py`) on the
CPU: two gloo ranks on 127.0.0.1 (`torch_parallel_worker.py`, one launch
with its timeout) against the JAX package's UNSHARDED fused program and
C3D tower on the same inputs, in f32: maps at rtol 1e-4 / atol 1e-5 (the
JAX package's temporal tolerances), conv5b features at max |delta| <=
1e-4 * max |JAX| (the tower's rule in `test_torch_c3d.py`):

  * the temporal fused predict of one video of two windows (one per rank)
    and of two videos of one window (the split axis is the folded
    batch*windows one), the same maps on both ranks;
  * the temporal extract: each rank's strip of the windows' features;
  * both guards' errors (batch*windows, then the raw frame axis).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from recurrent_gaze_prediction_tpu import registry as jregistry
from recurrent_gaze_prediction_tpu.models import c3d as jc3d
from recurrent_gaze_prediction_tpu.models import pipeline as jpipeline
from test_torch_c3d import jax_c3d_params
from torch_parallel_worker import launch, results_of

TOL = dict(rtol=1e-4, atol=1e-5)


def _model(t: int, seed: int):
    widths = dict(n_lstm_steps=t, dim_cnn_proj=32, rnn_state_size=16,
                  compute_dtype="float32")
    jmodel = jregistry.create_model("gaze_grcn", **widths)
    params = jmodel.init(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    params["cell"] = {k: jnp.asarray(rng.randn(*v.shape).astype(np.float32)
                                     * 0.3)
                      for k, v in params["cell"].items()}
    return jmodel, jax.tree_util.tree_map(np.asarray, params), widths


def _video(b: int, f: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).randint(
        0, 256, (b, f, 128, 171, 3)).astype(np.uint8)


def _tower():
    c3d = jax_c3d_params(seed=1, fc=False)
    c3d["conv1a_w"] = c3d["conv1a_w"] / 128.0  # conv5b O(1)
    return c3d


# (batch, frames): one video of two windows, two videos of one window
CASES = {"one_video": (1, 32), "two_videos": (2, 16)}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("temporal"))
    c3d = _tower()
    inputs = {"mesh": (2, 1)}
    models = {}
    for i, (case, (b, f)) in enumerate(CASES.items()):
        jmodel, params, widths = _model(jpipeline.pipeline_timesteps(f), i)
        models[case] = jmodel
        bad = ([np.zeros((1, 48, 8, 8, 3), np.uint8),    # 3 windows
                np.zeros((1, 33, 8, 8, 3), np.uint8)]    # 2 windows + 1
               if case == "one_video" else [])
        inputs[f"temporal_predict:{case}"] = dict(
            name="gaze_grcn", params=params, widths=widths, c3d=c3d,
            video=_video(b, f, 3 + i), bad_videos=bad)
    inputs["temporal_extract"] = dict(
        c3d=c3d, video=_video(1, 64, 9),                 # 4 windows
        bad_videos=[np.zeros((1, 48, 8, 8, 3), np.uint8),
                    np.zeros((1, 33, 8, 8, 3), np.uint8)])
    names = [f"temporal_predict:{c}" for c in CASES] + ["temporal_extract"]
    return inputs, launch(work, 2, inputs, names, timeout=300), models


@pytest.mark.parametrize("case", sorted(CASES))
def test_temporal_fused_predict_matches_jax(world2, case):
    inputs, results, models = world2
    spec = inputs[f"temporal_predict:{case}"]
    want = np.asarray(jpipeline.extract_and_predict(
        {k: jnp.asarray(v) for k, v in spec["c3d"].items()}, spec["params"],
        models[case], jnp.asarray(spec["video"]),
        compute_dtype=jnp.float32))
    for rank in results_of(results, f"temporal_predict:{case}"):
        assert rank["maps"].shape == want.shape
        np.testing.assert_allclose(rank["maps"], want, **TOL)


def test_temporal_guards_name_the_axis(world2):
    inputs, results, _ = world2
    for rank in results_of(results, "temporal_predict:one_video"):
        windows, frames = rank["errors"]
        assert "batch*windows (1*3) divisible by the data axis (2)" in windows
        assert "frame axis (33 frames)" in frames
    for rank in results_of(results, "temporal_extract"):
        windows, frames = rank["errors"]
        assert "windows (3) must be divisible by the data axis (2)" in windows
        assert "frame axis (33 frames)" in frames


def test_temporal_extract_keeps_each_ranks_strip(world2):
    inputs, results, _ = world2
    spec = inputs["temporal_extract"]
    video = jnp.asarray(spec["video"])
    clips = video.reshape(4, 16, *video.shape[2:])
    want = jc3d.apply({k: jnp.asarray(v) for k, v in spec["c3d"].items()},
                      jc3d.preprocess_frames(clips), feature_layer="conv5b",
                      compute_dtype=jnp.float32)
    want = np.asarray(jc3d.conv5b_to_rgp(want)).reshape(1, 4, 1024, 7, 7)
    for r, rank in enumerate(results_of(results, "temporal_extract")):
        assert rank["feats"].shape == (1, 2, 1024, 7, 7)
        strip = want[:, 2 * r:2 * r + 2]
        assert np.abs(rank["feats"] - strip).max() <= \
            1e-4 * np.abs(strip).max()
