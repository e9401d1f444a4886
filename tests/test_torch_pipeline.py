"""The raw-video pipeline (C3D tower -> gaze model in one program) and the
bundle's `fused` program: the port against the JAX package on the CPU in
f32, with the full C3D tower and narrow gaze widths, the weights made from
a seed with numpy and carried across by the bridge.

extract_and_predict's logits and maps at rtol 1e-4 / atol 1e-5 (maps,
~1/2401 each, at atol 1e-8); a JAX bundle's fused program served by the
port at corr >= 0.9999 against the JAX program's own maps.
"""

import io
import threading
import urllib.request

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recurrent_gaze_prediction_tpu import registry as jregistry
from recurrent_gaze_prediction_tpu.models import pipeline as jpipeline
from recurrent_gaze_prediction_tpu.ops.normalize import (
    softmax_2d as jsoftmax_2d)
from recurrent_gaze_prediction_tpu.serving import load_bundle as j_load_bundle
from recurrent_gaze_prediction_tpu.serving import save_bundle as j_save_bundle
from recurrent_gaze_prediction_tpu_torch import registry
from recurrent_gaze_prediction_tpu_torch.bridge import (c3d_params_from_jax,
                                                        params_from_jax)
from recurrent_gaze_prediction_tpu_torch.models import c3d, pipeline
from recurrent_gaze_prediction_tpu_torch.serving import (
    fused_predict_fn, load_bundle, save_bundle, server_from_bundle)
from test_torch_c3d import jax_c3d_params

WIDTHS = dict(dim_cnn_proj=32, rnn_state_size=16, compute_dtype="float32")


def _pair(name: str, t: int, seed: int = 0):
    """The JAX gaze model with random params (the recurrent cell at a scale
    where it matters) and the port's model with the same weights."""
    jmodel = jregistry.create_model(name, n_lstm_steps=t, **WIDTHS)
    params = jmodel.init(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    params["cell"] = {k: jnp.asarray(rng.randn(*v.shape).astype(np.float32)
                                     * 0.3)
                      for k, v in params["cell"].items()}
    tmodel = registry.create_model(name, n_lstm_steps=t, device="cpu",
                                   **WIDTHS)
    tmodel.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jmodel, params, tmodel


@pytest.fixture(scope="module")
def tower():
    """He-scaled C3D weights with conv1a scaled by 1/128, so conv5b comes
    out O(1) from mean-subtracted pixels, as trained weights give it (at
    O(100) the gaze model's projection amplifies the two packages' f32
    summation-order noise past the tolerance)."""
    jparams = jax_c3d_params(seed=1, fc=False)
    jparams["conv1a_w"] = jparams["conv1a_w"] / 128.0
    return ({k: jnp.asarray(v) for k, v in jparams.items()},
            c3d_params_from_jax(jparams))


def test_pipeline_timesteps_match_jax():
    for f in (0, 15, 16, 20, 31, 32, 80, 160, 161):
        assert pipeline.pipeline_timesteps(f) == \
            jpipeline.pipeline_timesteps(f)


@pytest.mark.parametrize("name,cube", [("gaze_grcn", False),
                                       ("gaze_lstm", False),
                                       ("gaze_grcn", True)])
def test_extract_and_predict_matches_jax(tower, name, cube):
    jc3d, tc3d = tower
    b, f = 2, 32
    t = pipeline.pipeline_timesteps(f)
    assert t == 2
    jmodel, jparams, tmodel = _pair(name, t)
    rng = np.random.RandomState(2)
    # frames at the tower's 128x171, as a bundle takes them (the resize,
    # which differs by up to ~4e-4 between the packages, is held on its
    # own in test_torch_c3d.py)
    video = rng.randint(0, 256, (b, f, 128, 171, 3)).astype(np.uint8)
    # a mean cube of video pixels: ~100 per pixel, varying a little
    mean = (101.2 + 10 * rng.randn(16, 112, 112, 3)).astype(np.float32) \
        if cube else None
    jmean = None if mean is None else jnp.asarray(mean)
    kw = dict(compute_dtype=None)
    j_logits = jpipeline.extract_and_predict(
        jc3d, jparams, jmodel, jnp.asarray(video, jnp.float32),
        mean_cube=jmean, logits=True, compute_dtype=jnp.float32)
    # the JAX package's predict is this softmax of the same logits
    j_maps = np.asarray(jsoftmax_2d(j_logits))
    with torch.no_grad():
        t_logits = pipeline.extract_and_predict(
            tc3d, tmodel, torch.from_numpy(video), mean_cube=mean,
            logits=True, **kw).numpy()
    t_maps = pipeline.extract_and_predict(
        tc3d, tmodel, torch.from_numpy(video), mean_cube=mean, **kw).numpy()
    assert t_logits.shape == (b, t, 49, 49)
    # U=16 is a width the kernels take: on the CPU their wrappers run the
    # plain versions
    assert tmodel.last_route == "kernel"
    np.testing.assert_allclose(t_logits, np.asarray(j_logits), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(t_maps, j_maps, rtol=1e-4, atol=1e-8)


def test_extract_and_predict_feeds_frames_to_framewise_shallownet(tower):
    """gaze_framewise_shallownet is the model whose forward reads `frames`:
    the frame stream (every 5th frame from 15, antialiased resize from
    128x171 to 98x98, scaled to [0, 1]) feeds its ShallowNet. Against the
    JAX package's `extract_and_predict` (the two resizes differ by up to
    ~4e-4 on 0..255, 1.6e-6 after the scaling, which ShallowNet carries to
    the maps well inside the tolerance). Its forward reads no C3D
    features, so the tower is skipped (as XLA drops it from the JAX
    package's compiled program)."""
    jc3d, tc3d = tower
    b, f = 2, 32
    t = pipeline.pipeline_timesteps(f)
    jmodel = jregistry.create_model("gaze_framewise_shallownet",
                                    n_lstm_steps=t, compute_dtype="float32")
    jparams = jmodel.init(jax.random.PRNGKey(3))
    tmodel = registry.create_model("gaze_framewise_shallownet", device="cpu",
                                   n_lstm_steps=t, compute_dtype="float32")
    tmodel.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams)))
    assert tmodel.reads_frames
    video = np.random.RandomState(4).randint(
        0, 256, (b, f, 128, 171, 3)).astype(np.uint8)
    want = np.asarray(jpipeline.extract_and_predict(
        jc3d, jparams, jmodel, jnp.asarray(video, jnp.float32),
        compute_dtype=jnp.float32))
    got = pipeline.extract_and_predict(tc3d, tmodel, torch.from_numpy(video),
                                       compute_dtype=None).numpy()
    assert got.shape == (b, t, 49, 49)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # the model reads no features, so the tower does not run for it
    assert not tmodel.reads_c3d
    np.testing.assert_array_equal(pipeline.extract_and_predict(
        None, tmodel, torch.from_numpy(video), compute_dtype=None).numpy(),
        got)


def test_fused_predict_refuses_another_frame_count(tower):
    _, tc3d = tower
    _, _, tmodel = _pair("gaze_grcn", 1)
    fn = pipeline.make_fused_predict(tmodel, num_frames=32)
    with pytest.raises(ValueError, match="num_frames=32"):
        fn(tc3d, torch.zeros((1, 16, 64, 80, 3), dtype=torch.uint8))


def test_predict_video_on_an_avi(tmp_path, tower):
    jc3d, tc3d = tower
    path = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 25.0,
                             (80, 64))
    rng = np.random.RandomState(3)
    for i in range(20):
        frame = np.full((64, 80, 3), 40, np.uint8)
        frame[10 + i:30 + i, 20:40] = rng.randint(150, 256)
        writer.write(frame)
    writer.release()
    jmodel, jparams, tmodel = _pair("gaze_grcn", 1)
    j_maps, j_valid = jpipeline.predict_video(
        jc3d, jparams, jmodel, path, compute_dtype=jnp.float32)
    t_maps, t_valid = pipeline.predict_video(tc3d, tmodel, path,
                                             compute_dtype=None)
    assert t_valid == j_valid == 1
    assert t_maps.shape == (1, 49, 49)
    np.testing.assert_allclose(t_maps.numpy(), np.asarray(j_maps),
                               rtol=1e-4, atol=1e-8)


def _post(url, video):
    buf = io.BytesIO()
    np.savez(buf, video=video)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.status, np.load(io.BytesIO(resp.read()))["gazemaps"]


def _corr(a, b):
    return float(np.corrcoef(np.ravel(a), np.ravel(b))[0, 1])


def test_port_serves_a_jax_fused_bundle(tmp_path, tower, monkeypatch):
    """A JAX bundle's `fused` program (uint8 video, the tower in f32 as the
    JAX export runs it) served by the port: concurrent POSTs get the JAX
    program's maps back, and the pixels reach the tower still uint8. (The
    JAX export fixes the fc layers' full shapes, so this tower has them.)"""
    del tower
    full = jax_c3d_params(seed=1)
    full["conv1a_w"] = full["conv1a_w"] / 128.0
    jc3d = {k: jnp.asarray(v) for k, v in full.items()}
    jmodel, jparams, _ = _pair("gaze_grcn", 1)
    j_save_bundle(str(tmp_path), jmodel, jparams, c3d_params=jc3d,
                  num_frames=16, video_hw=(64, 80), platforms=("cpu",),
                  video_dtype="uint8")
    video = np.random.RandomState(4).randint(
        0, 256, (2, 16, 64, 80, 3)).astype(np.uint8)
    want = np.asarray(j_load_bundle(str(tmp_path)).predict_fused(
        jnp.asarray(video)))

    seen = []
    preprocess = c3d.preprocess_frames

    def spy(frames, *args, **kwargs):
        seen.append(frames.dtype)
        return preprocess(frames, *args, **kwargs)

    monkeypatch.setattr(c3d, "preprocess_frames", spy)
    results = [None] * 2
    with server_from_bundle(str(tmp_path), program="fused", device="cpu",
                            max_batch=2, max_wait_ms=500.0).start() as srv:
        url = "http://%s:%d/predict" % srv.address

        def one(i):
            results[i] = _post(url, video[i])

        threads = [threading.Thread(target=one, args=(i,)) for i in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        assert not any(th.is_alive() for th in threads)
        assert srv.batcher.requests == 2
    assert seen and all(d == torch.uint8 for d in seen)
    for i, (status, maps) in enumerate(results):
        assert status == 200 and maps.shape == (1, 49, 49)
        assert _corr(maps, want[i]) >= 0.9999


def test_port_fused_bundle_roundtrip(tmp_path, tower):
    """A bundle the port writes with a fused program: the JAX layout on
    disk, and the same maps from the loaded program as from
    make_fused_predict on the saved weights."""
    _, tc3d = tower
    _, _, tmodel = _pair("gaze_lstm", 1)
    save_bundle(str(tmp_path), tmodel, c3d_params=tc3d, num_frames=16,
                video_hw=(64, 80), video_dtype="uint8",
                c3d_compute_dtype="float32")
    with np.load(tmp_path / "c3d_params.npz") as blob:
        assert blob["conv1a_w"].shape == (3, 3, 3, 3, 64)  # DHWIO
    loaded = load_bundle(str(tmp_path), device="cpu")
    assert loaded.bundle_programs["fused"]["num_frames"] == 16
    video = torch.from_numpy(np.random.RandomState(5).randint(
        0, 256, (1, 16, 64, 80, 3)).astype(np.uint8))
    got = fused_predict_fn(loaded)(video)
    want = pipeline.make_fused_predict(tmodel, num_frames=16,
                                       compute_dtype=None)(tc3d, video)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-9)
