"""The port's int8 C3D tower (`models/quant.py`, kernel Q1's plain version)
against the JAX package's `models/quant.py` on the CPU:

  * `quantize_c3d`'s int8 weights and scales bit-equal to JAX's, through
    `bridge.qparams_from_jax` / `qparams_to_jax` and back bit for bit;
  * `calibrate_c3d`'s scales at rtol 1e-5 (the f32 towers differ only in
    summation order), also through `quantize_for_pipeline`'s synthetic
    clips (the same `RandomState` draw in both packages);
  * Q1's plain int32 conv equal to JAX's `_conv3d_int8`;
  * `apply_int8` on JAX's qparams equal to JAX's `apply_int8` (conv5b f32
    features bitwise: the epilogue is the same IEEE operations in the same
    order), and the JAX package's accuracy gate against the f32 tower;
  * a bundle written by the JAX package with int8 qparams serves the same
    `fused_int8` maps from the port as JAX's `predict_fused_int8`, the
    port's server routes `fused_int8`, and `cli.export_serving --int8
    --calib_videos` runs end to end.

The bundle tests use a thin tower (8 channels up to conv5a, conv5b's 512:
the gaze models read 1024 folded channels), so the full 112x112 clip the
fused program crops stays cheap on the CPU.
"""

import io
import os
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recurrent_gaze_prediction_tpu import registry as jregistry
from recurrent_gaze_prediction_tpu.models import c3d as jc3d
from recurrent_gaze_prediction_tpu.models import quant as jquant
from recurrent_gaze_prediction_tpu.serving import load_bundle as jload_bundle
from recurrent_gaze_prediction_tpu.serving import save_bundle as jsave_bundle
from recurrent_gaze_prediction_tpu_torch import registry
from recurrent_gaze_prediction_tpu_torch.bridge import (
    c3d_params_from_jax, qparams_from_jax, qparams_to_jax)
from recurrent_gaze_prediction_tpu_torch.cli import export_serving
from recurrent_gaze_prediction_tpu_torch.config import ExperimentConfig
from recurrent_gaze_prediction_tpu_torch.models import c3d, quant
from recurrent_gaze_prediction_tpu_torch.models.pipeline import (
    make_fused_predict)
from recurrent_gaze_prediction_tpu_torch.ops.kernels import conv3d_int8 as q1
from recurrent_gaze_prediction_tpu_torch.serving import (
    fused_int8_predict_fn, fused_predict_fn, load_bundle, read_manifest,
    save_bundle, server_from_bundle)
from recurrent_gaze_prediction_tpu_torch.train import (
    Checkpointer, create_train_state)

SMALL = dict(dim_cnn_proj=8, rnn_state_size=8, compute_dtype="float32")


def _scaled_params(key=0, factor=12.0):
    """The JAX test's tower (tests/test_quant.py): random init with the conv
    weights scaled so activations survive all 8 layers; conv layers only."""
    params = jc3d.init_params(jax.random.PRNGKey(key))
    return {k: np.asarray(v * factor if k.endswith("_w") else v)
            for k, v in params.items() if k.startswith("conv")}


def _thin_tower(seed=5):
    """JAX-layout conv weights, 8 channels up to conv5a and 512 at conv5b,
    w / sqrt(27 Cin) (the JAX test's fabricated caffemodel); 8x8 fc
    placeholders, which no path here reads."""
    rng = np.random.RandomState(seed)
    params, cin = {}, 3
    for name, _ in jc3d.CONV_LAYERS:
        cout = 512 if name == "conv5b" else 8
        params[f"{name}_w"] = (rng.randn(3, 3, 3, cin, cout)
                               / np.sqrt(27.0 * cin)).astype(np.float32)
        params[f"{name}_b"] = (0.01 * rng.randn(cout)).astype(np.float32)
        cin = cout
    for name, _, _ in jc3d.FC_LAYERS:
        params[f"{name}_w"] = np.zeros((8, 8), np.float32)
        params[f"{name}_b"] = np.zeros(8, np.float32)
    return params


def _to_port_clips(clips: np.ndarray) -> torch.Tensor:
    """[N, 16, H, W, 3] (the JAX layout) -> the port's [N, 3, 16, H, W]
    view of the same NDHWC memory."""
    return torch.from_numpy(np.ascontiguousarray(clips)).permute(0, 4, 1, 2, 3)


@pytest.fixture(scope="module")
def small():
    """The JAX test's tower and clips at [1, 16, 16, 16, 3], with JAX's
    calibration, qparams and int8 features."""
    params = _scaled_params()
    raw = np.random.RandomState(0).rand(1, 16, 16, 16, 3).astype(np.float32)
    clips = raw * 255.0 - 101.2
    scales = jquant.calibrate_c3d(params, jnp.asarray(clips))
    qparams = jquant.quantize_c3d(params, scales)
    feats = np.asarray(jquant.apply_int8(qparams, jnp.asarray(clips)))
    return params, clips, scales, qparams, feats


def test_quantize_c3d_matches_jax_bitwise(small):
    params, _, scales, jq, _ = small
    port = quant.quantize_c3d(c3d_params_from_jax(params), scales)
    assert set(port) == set(jq)
    back = qparams_to_jax(port)
    for key, want in jq.items():
        want = np.asarray(want)
        assert back[key].dtype == want.dtype, key
        np.testing.assert_array_equal(back[key], want, err_msg=key)
    # the bridge carries JAX's qparams in and out bit for bit
    carried = qparams_to_jax(qparams_from_jax(
        {k: np.asarray(v) for k, v in jq.items()}))
    for key, want in jq.items():
        np.testing.assert_array_equal(carried[key], np.asarray(want))
    assert port["conv1a_wq"].shape == (64, q1.packed_k(3)) == (64, 128)
    assert port["conv2a_wq"].shape == (128, 27 * 64)


def test_calibrate_c3d_matches_jax(small):
    params, clips, scales, _, _ = small
    port = quant.calibrate_c3d(c3d_params_from_jax(params),
                               _to_port_clips(clips))
    assert list(port) == list(scales)
    for name, want in scales.items():
        np.testing.assert_allclose(port[name], want, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("cin,cout,dhw", [(3, 64, (4, 6, 5)),
                                          (64, 128, (3, 4, 4)),
                                          (128, 64, (2, 3, 3))])
def test_plain_int32_conv_matches_jax(cin, cout, dhw):
    rng = np.random.RandomState(cin)
    x = rng.randint(-127, 128, (2, *dhw, cin)).astype(np.int8)
    w = rng.randint(-127, 128, (3, 3, 3, cin, cout)).astype(np.int8)
    want = np.asarray(jquant._conv3d_int8(jnp.asarray(x), jnp.asarray(w)))
    packed = torch.from_numpy(q1.pack_weights(np.transpose(w,
                                                           (4, 3, 0, 1, 2))))
    got = q1.conv3d_int32_plain(torch.from_numpy(x), packed)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_apply_int8_matches_jax(small):
    """The same qparams (JAX's, carried across) on the same clips: the
    conv5b features are bitwise JAX's."""
    _, clips, _, jq, want = small
    qparams = qparams_from_jax({k: np.asarray(v) for k, v in jq.items()})
    got = quant.apply_int8(qparams, _to_port_clips(clips))
    assert got.shape == (1, 512, 2, 1, 1) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.permute(0, 2, 3, 4, 1).numpy(), want)


def test_int8_tower_tracks_the_f32_tower():
    """The JAX package's accuracy gate (tests/test_quant.py) on the port:
    the int8 tower against the f32 tower, corr > 0.995, mean rel < 0.06."""
    params = c3d_params_from_jax(_scaled_params())
    raw = np.random.RandomState(0).rand(2, 16, 24, 32, 3).astype(np.float32)
    clips = _to_port_clips(raw * 255.0 - 101.2)
    ref = c3d.apply(params, clips, compute_dtype=None).numpy()
    qparams = quant.quantize_c3d(params, quant.calibrate_c3d(params, clips))
    got = quant.apply_int8(qparams, clips).numpy()
    assert got.shape == ref.shape
    corr = np.corrcoef(ref.ravel(), got.ravel())[0, 1]
    rel = np.abs(got - ref).mean() / (np.abs(ref).mean() + 1e-9)
    assert corr > 0.995, corr
    assert rel < 0.06, rel


def test_quantize_for_pipeline_synthetic_matches_jax(monkeypatch):
    """No calibration clips: both packages draw the same synthetic clips
    from `RandomState(seed)`, warn, and give the same qparams (scales at
    rtol 1e-5, int8 weights equal); the int8 range is used."""
    warnings = []
    monkeypatch.setattr(quant.log, "warn",
                        lambda msg, *args: warnings.append(msg % args))
    tower = _thin_tower()
    port = qparams_to_jax(quant.quantize_for_pipeline(
        c3d_params_from_jax(tower), seed=3))
    assert len(warnings) == 1 and "synthetic" in warnings[0]
    jq = jquant.quantize_for_pipeline(
        {k: jnp.asarray(v) for k, v in tower.items()}, seed=3)
    for key, want in jq.items():
        want = np.asarray(want)
        if key.endswith("_xscale"):
            np.testing.assert_allclose(port[key], want, rtol=1e-5)
            assert float(port[key]) > 0
        else:
            np.testing.assert_array_equal(port[key], want, err_msg=key)
    w1 = port["conv1a_wq"]
    assert w1.max() == 127 or w1.min() == -127


@pytest.fixture(scope="module")
def jax_int8_bundle(tmp_path_factory):
    """A bundle written by the JAX package's `save_bundle` with the thin
    tower's int8 qparams (gaze_grcn at small widths, F=16, uint8 video;
    no `fused` program, whose export takes the full tower's shapes), and
    JAX's fused_int8 maps of one video."""
    path = str(tmp_path_factory.mktemp("jax_int8") / "bundle")
    model = jregistry.create_model("gaze_grcn", n_lstm_steps=1, batch_size=1,
                                   **SMALL)
    gaze = model.init(jax.random.PRNGKey(1))
    tower = {k: jnp.asarray(v) for k, v in _thin_tower().items()}
    video = np.random.RandomState(8).randint(
        0, 256, (1, 16, 128, 171, 3)).astype(np.uint8)
    calib = jc3d.preprocess_frames(jnp.asarray(video, jnp.float32))
    qparams = jquant.quantize_c3d(tower, jquant.calibrate_c3d(tower, calib))
    jsave_bundle(path, model, gaze, num_frames=16, int8_qparams=qparams,
                 platforms=("cpu",), video_dtype="uint8")
    bundle = jload_bundle(path)
    return path, video, np.asarray(bundle.predict_fused_int8(video))


def test_jax_int8_bundle_serves_the_same_maps(jax_int8_bundle):
    path, video, want = jax_int8_bundle
    model = load_bundle(path, device="cpu")
    assert model.bundle_qparams_int8 is not None
    got = fused_int8_predict_fn(model)(video).numpy()
    assert got.shape == want.shape == (1, 1, 49, 49)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    # and track the same model on the f32 tower
    f32 = make_fused_predict(model, num_frames=16, compute_dtype=None)(
        c3d_params_from_jax(_thin_tower()), torch.from_numpy(video)).numpy()
    assert np.corrcoef(got.ravel(), f32.ravel())[0, 1] >= 0.98
    # the port writes the same qparams file back
    out = os.path.join(os.path.dirname(path), "port_bundle")
    save_bundle(out, model, num_frames=16, video_dtype="uint8",
                int8_qparams=model.bundle_qparams_int8)
    with np.load(os.path.join(path, "qparams_int8.npz")) as a, \
            np.load(os.path.join(out, "qparams_int8.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert read_manifest(out)["torch_programs"]["fused_int8"] == {
        "inputs": "qparams_int8, params, video [B,F,H,W,3] uint8 0..255",
        "num_frames": 16, "video_hw": [128, 171], "video_dtype": "uint8"}


def test_server_routes_fused_int8(jax_int8_bundle):
    """`server_from_bundle(program="fused_int8")`: a uint8 POST gets the
    bundle's fused_int8 maps."""
    path, video, _ = jax_int8_bundle
    want = fused_int8_predict_fn(load_bundle(path, device="cpu"))(
        video).numpy()
    with server_from_bundle(path, program="fused_int8", device="cpu",
                            max_wait_ms=1.0).start() as server:
        host, port = server.address
        body = io.BytesIO()
        np.savez(body, video=video[0])
        req = urllib.request.Request(f"http://{host}:{port}/predict",
                                     data=body.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.status == 200
            maps = np.load(io.BytesIO(resp.read()))["gazemaps"]
    np.testing.assert_allclose(maps, want[0], rtol=1e-5, atol=1e-7)


def _port_run(train_dir: str) -> None:
    """A port checkpoint of gaze_grcn at small widths (T=1), as
    `cli.train_gaze` leaves one."""
    exp = ExperimentConfig()
    exp.model.name = "gaze_grcn"
    exp.model.n_lstm_steps = 1
    for key, value in SMALL.items():
        setattr(exp.model, key, value)
    model = registry.create_model("gaze_grcn", exp.model, device="cpu")
    state, _ = create_train_state(model, exp.optimizer)
    ckpt = Checkpointer(train_dir)
    ckpt.save_config(exp)
    ckpt.save(state)


def test_export_serving_int8_with_calibration_videos(tmp_path):
    """`cli.export_serving --int8 --calib_videos`: calibrated on the
    decoded windows (the scales `calibrate_c3d` gives on them), a bundle
    whose fused_int8 maps track its fused maps (corr >= 0.98)."""
    cv2 = pytest.importorskip("cv2")
    run, out = str(tmp_path / "run"), str(tmp_path / "bundle")
    _port_run(run)
    tower = str(tmp_path / "tower.npz")
    np.savez(tower, **_thin_tower())
    calib = tmp_path / "calib"
    calib.mkdir()
    writer = cv2.VideoWriter(str(calib / "c.avi"),
                             cv2.VideoWriter_fourcc(*"MJPG"), 10, (64, 48))
    assert writer.isOpened()
    rng = np.random.RandomState(9)
    for _ in range(16):
        writer.write(rng.randint(0, 255, (48, 64, 3), np.uint8))
    writer.release()
    assert export_serving.main([
        "--train_dir", run, "--out_dir", out, "--caffemodel", tower,
        "--fused_num_frames", "16", "--int8", "--calib_videos", str(calib),
        "--calib_windows", "1", "--video_dtype", "uint8",
        "--device", "cpu"]) == 0
    model = load_bundle(out, device="cpu")
    assert {"predict", "fused", "fused_int8"} <= set(model.bundle_programs)
    clips = export_serving.load_calibration_clips(str(calib), 1,
                                                  torch.device("cpu"))
    assert clips.shape == (1, 3, 16, 112, 112)
    scales = quant.calibrate_c3d(model.bundle_c3d_params, clips)
    for name, want in scales.items():
        assert float(model.bundle_qparams_int8[f"{name}_xscale"]) == \
            np.float32(want)
    video = rng.randint(0, 256, (1, 16, 128, 171, 3)).astype(np.uint8)
    got = fused_int8_predict_fn(model)(video).numpy()
    ref = fused_predict_fn(model)(video).numpy()
    assert got.shape == ref.shape == (1, 1, 49, 49)
    assert np.isfinite(got).all()
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] >= 0.98
