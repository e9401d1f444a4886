"""The port's host-side interop against the JAX package on the CPU:

  * the TFRecord codec (`compat/tfrecord.py`): files written by either
    package are byte-identical and each reads the other's; truncated and
    corrupt files raise; real tf.io reads the port's records and the port
    reads tf.io's;
  * the TF1 checkpoint import (`compat/tf_import.py`) on a checkpoint with
    the reference's variable names, built as tests/test_compat.py builds
    it: the same arrays as the JAX import, and the port's ShallowNet and
    gaze_grcn forwards on the imported weights against the JAX package's
    (rtol 1e-4, and atol 1e-5, or for ShallowNet's outputs of ~1e2 1e-6 of
    their largest); the deconv kernel conversion against
    tf.nn.conv2d_transpose;
  * the grain loader (`data/grain_pipeline.py`): the same batches as the
    JAX package's for the same seed and shards, and `train.fit` driven by
    it;
  * the native libraries (`native/`): built with g++, the blob codec and
    batch reader against the NumPy codec, the JPEG batch decoder against
    PIL, and `load_frame_folder(backend="native")` against the JAX
    package's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from recurrent_gaze_prediction_tpu import native as jnative
from recurrent_gaze_prediction_tpu import registry as jregistry
from recurrent_gaze_prediction_tpu.compat import tf_import as jtf_import
from recurrent_gaze_prediction_tpu.compat import tfrecord as jtfrecord
from recurrent_gaze_prediction_tpu.data import grain_pipeline as jgrain
from recurrent_gaze_prediction_tpu.data import synthetic as jsynthetic
from recurrent_gaze_prediction_tpu.data import video as jvideo
from recurrent_gaze_prediction_tpu.models import shallownet as jshallownet
from recurrent_gaze_prediction_tpu_torch import native, registry
from recurrent_gaze_prediction_tpu_torch.bridge import params_from_jax
from recurrent_gaze_prediction_tpu_torch.compat import tf_import, tfrecord
from recurrent_gaze_prediction_tpu_torch.config import ExperimentConfig
from recurrent_gaze_prediction_tpu_torch.data import (codec, grain_pipeline,
                                                      synthetic, video)
from recurrent_gaze_prediction_tpu_torch.models import shallownet
from recurrent_gaze_prediction_tpu_torch.ops.layers import conv2d_transpose
from recurrent_gaze_prediction_tpu_torch.train import create_train_state, fit

# ---------------------------------------------------------------- TFRecord


def _examples(n=3, seed=0):
    rng = np.random.RandomState(seed)
    return [{
        "/input/frame": rng.rand(98, 98, 3).astype(np.float32),
        "/input/c3d": rng.rand(1024, 7, 7).astype(np.float32),
        "/input/gazemaps_gt": rng.rand(49, 49).astype(np.float32),
        "/input/gazemaps_pred": rng.rand(49, 49).astype(np.float32),
        "/label/label": (rng.rand(13) > 0.8).astype(np.uint8),
    } for _ in range(n)]


def _assert_examples_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            assert g[key].dtype == w[key].dtype
            np.testing.assert_array_equal(g[key], w[key])


def test_tfrecord_files_are_byte_identical_across_packages(tmp_path):
    examples = _examples()
    ours, theirs = str(tmp_path / "port.tfrecord"), str(tmp_path / "jax.tfr")
    tfrecord.write_reference_tfrecord(ours, examples)
    jtfrecord.write_reference_tfrecord(theirs, examples)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    _assert_examples_equal(tfrecord.read_reference_tfrecord(theirs), examples)
    _assert_examples_equal(jtfrecord.read_reference_tfrecord(ours), examples)
    payload = tfrecord.encode_example({"k": b"\x00\x01v"})
    assert payload == jtfrecord.encode_example({"k": b"\x00\x01v"})
    assert tfrecord.decode_example(payload) == {"k": b"\x00\x01v"}
    assert tfrecord._crc32c(b"123456789") == 0xE3069283  # the CRC-32C check


@pytest.mark.parametrize("cut", [5, 20, -2])
def test_truncated_or_corrupt_tfrecord_raises(tmp_path, cut):
    path = str(tmp_path / "r.tfrecord")
    tfrecord.write_reference_tfrecord(path, _examples(1))
    data = open(path, "rb").read()
    open(path, "wb").write(data[:cut])
    with pytest.raises(IOError, match="truncated"):
        tfrecord.read_reference_tfrecord(path)
    corrupt = bytearray(data)
    corrupt[20] ^= 0xFF
    open(path, "wb").write(bytes(corrupt))
    with pytest.raises(IOError, match="crc"):
        tfrecord.read_reference_tfrecord(path)


def test_tfrecord_interop_with_tf_io(tmp_path):
    tf = pytest.importorskip("tensorflow")
    examples = _examples(2, seed=1)
    ours = str(tmp_path / "port.tfrecord")
    tfrecord.write_reference_tfrecord(ours, examples)
    spec = {k: tf.io.FixedLenFeature([], tf.string)
            for k in tfrecord.SCHEMA}
    read = []
    for raw in tf.data.TFRecordDataset(ours):
        parsed = tf.io.parse_single_example(raw, spec)
        read.append({k: np.frombuffer(parsed[k].numpy(), dtype=dt).reshape(
            shape) for k, (dt, shape) in tfrecord.SCHEMA.items()})
    _assert_examples_equal(read, examples)

    theirs = str(tmp_path / "tf.tfrecord")
    with tf.io.TFRecordWriter(theirs) as writer:
        for example in examples:
            feature = {k: tf.train.Feature(bytes_list=tf.train.BytesList(
                value=[np.ascontiguousarray(v).tobytes()]))
                for k, v in example.items()}
            writer.write(tf.train.Example(features=tf.train.Features(
                feature=feature)).SerializeToString())
    _assert_examples_equal(tfrecord.read_reference_tfrecord(theirs),
                           examples)


# ---------------------------------------------------------- TF1 checkpoints


@pytest.fixture(scope="module")
def tf_checkpoint(tmp_path_factory):
    """A TF1 checkpoint with the reference's ShallowNet + gaze_grcn variable
    names and two optimizer slots (tests/test_compat.py's)."""
    tf = pytest.importorskip("tensorflow")
    rng = np.random.RandomState(1)
    shapes = [
        ("ShallowNet/conv1/weights", (5, 5, 3, 32)),
        ("ShallowNet/conv1/biases", (32,)),
        ("ShallowNet/conv2/weights", (3, 3, 32, 64)),
        ("ShallowNet/conv2/biases", (64,)),
        ("ShallowNet/conv3/weights", (3, 3, 64, 32)),
        ("ShallowNet/conv3/biases", (32,)),
        ("ShallowNet/fc1/weights", (3872, 4802)),
        ("ShallowNet/fc1/biases", (4802,)),
        ("ShallowNet/fc2/weights", (2401, 4802)),
        ("ShallowNet/fc2/biases", (4802,)),
        ("RGP/proj_c3d_W", (1024, 512)),
        ("RGP/proj_c3d_b", (512,)),
        ("RGP/RCNBottom/GRU_Conv_Wz", (3, 3, 512, 128)),
        ("RGP/RCNBottom/GRU_Conv_Uz", (3, 3, 128, 128)),
        ("RGP/RCNBottom/GRU_Conv_Wr", (3, 3, 512, 128)),
        ("RGP/RCNBottom/GRU_Conv_Ur", (3, 3, 128, 128)),
        ("RGP/RCNBottom/GRU_Conv_W", (3, 3, 512, 128)),
        ("RGP/RCNBottom/GRU_Conv_U", (3, 3, 128, 128)),
        ("RGP/Upsampling/weight1", (5, 5, 64, 128)),   # [h, w, out, in]
        ("RGP/Upsampling/weight2", (5, 5, 32, 64)),
        ("RGP/Upsampling/weight3", (7, 7, 12, 32)),
        ("RGP/out_W", (12, 1)),
        ("RGP/out_b", (1,)),
        ("RGP/batch_normalization/gamma", (128,)),
        ("RGP/batch_normalization/beta", (128,)),
        ("RGP/out_W/Adam", (12, 1)),
        ("ShallowNet/conv1/weights/Adam_1", (5, 5, 3, 32)),
    ]
    variables = [tf.Variable(rng.randn(*shape).astype(np.float32) * 0.1,
                             name=name) for name, shape in shapes]
    path = str(tmp_path_factory.mktemp("tfckpt") / "ref_model")
    tf.compat.v1.train.Saver(var_list={
        v.name.split(":")[0]: v for v in variables}).save(None, path)
    return path


def test_tf_variables_and_mapping_match_jax(tf_checkpoint):
    ours = tf_import.load_tf_variables(tf_checkpoint)
    theirs = jtf_import.load_tf_variables(tf_checkpoint)
    assert sorted(ours) == sorted(theirs)
    assert not any("Adam" in n for n in ours)
    for name in ours:
        np.testing.assert_array_equal(ours[name], theirs[name])
    sn = tf_import.shallownet_params_from_tf(ours)
    jsn = jtf_import.shallownet_params_from_tf(theirs)
    assert sorted(sn) == sorted(jsn)
    for k in jsn:
        np.testing.assert_array_equal(sn[k].numpy(), jsn[k])
    state = tf_import.grcn_params_from_tf(ours)
    jstate = params_from_jax(jtf_import.grcn_params_from_tf(theirs))
    assert sorted(state) == sorted(jstate)
    for k in jstate:
        assert torch.equal(state[k], jstate[k]), k
    assert state["decoder.up1_w"].shape == (5, 5, 128, 64)


def test_imported_weights_give_the_jax_forwards(tf_checkpoint):
    variables = tf_import.load_tf_variables(tf_checkpoint)
    jvars = jtf_import.load_tf_variables(tf_checkpoint)
    images = np.random.RandomState(2).rand(2, 98, 98, 3).astype(np.float32)
    got = shallownet.apply(tf_import.shallownet_params_from_tf(variables),
                           torch.from_numpy(images))
    want = jshallownet.apply({k: jnp.asarray(v) for k, v in
                              jtf_import.shallownet_params_from_tf(
                                  jvars).items()}, jnp.asarray(images))
    assert got.shape == (2, 49, 49)
    # the checkpoint's 0.1-scaled weights put fc1's 3872-term sums near
    # 1e2, where f32 summation order moves them by up to ~6e-5 (measured):
    # the absolute tolerance follows the outputs' scale
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-6 * np.abs(want).max())

    model = registry.create_model("gaze_grcn", device="cpu", n_lstm_steps=2,
                                  batch_size=1, compute_dtype="float32")
    model.load_state_dict(tf_import.grcn_params_from_tf(variables))
    jmodel = jregistry.create_model("gaze_grcn", n_lstm_steps=2, batch_size=1,
                                    compute_dtype="float32")
    jparams = jax.tree_util.tree_map(
        jnp.asarray, jtf_import.grcn_params_from_tf(jvars))
    c3d = np.random.RandomState(3).rand(1, 2, 1024, 7, 7).astype(np.float32)
    frames = np.zeros((1, 2, 98, 98, 3), np.float32)
    with torch.no_grad():
        out = model(torch.from_numpy(frames), torch.from_numpy(c3d),
                    train=False)
    want = jmodel.apply(jparams, jnp.asarray(frames), jnp.asarray(c3d),
                        train=False)
    assert out.shape == (1, 2, 49, 49)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_deconv_kernel_conversion_matches_the_tf_op():
    tf = pytest.importorskip("tensorflow")
    rng = np.random.RandomState(0)
    x = rng.randn(1, 7, 7, 5).astype(np.float32)
    k_tf = rng.randn(5, 5, 3, 5).astype(np.float32)   # [h, w, out, in]
    want = tf.nn.conv2d_transpose(x, k_tf, output_shape=[1, 23, 23, 3],
                                  strides=[1, 3, 3, 1],
                                  padding="VALID").numpy()
    kernel = tf_import.tf_deconv_kernel_to_jax(k_tf)
    np.testing.assert_array_equal(kernel,
                                  jtf_import.tf_deconv_kernel_to_jax(k_tf))
    got = conv2d_transpose(torch.from_numpy(x), torch.from_numpy(kernel),
                           stride=3, padding="VALID")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------- grain


@pytest.mark.parametrize("kwargs", [
    dict(seed=1, num_epochs=1),
    dict(seed=4, num_epochs=2),
    dict(shuffle=False, num_epochs=1, shard_index=1, shard_count=2),
])
def test_grain_batches_equal_the_jax_loader(kwargs):
    pytest.importorskip("grain")
    data, jdata = (m.make_clip_windows(12, 3, seed=0)
                   for m in (synthetic, jsynthetic))
    ours = list(grain_pipeline.iterate_batches(
        grain_pipeline.make_dataloader(data, batch_size=2, **kwargs)))
    theirs = list(jgrain.iterate_batches(
        jgrain.make_dataloader(jdata, batch_size=2, **kwargs)))
    assert len(ours) == len(theirs) >= 3
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b)
        for key in b:
            np.testing.assert_array_equal(a[key], b[key])
    assert ours[0]["frames"].shape == (2, 3, 98, 98, 3)


def test_fit_with_grain_iterator():
    """`train.fit` driven by a grain DataLoader (the JAX package's
    test_fit_with_grain_iterator, on the port)."""
    pytest.importorskip("grain")
    exp = ExperimentConfig()
    exp.model.n_lstm_steps = 3
    exp.model.batch_size = 2
    exp.model.compute_dtype = "float32"
    exp.model.dim_cnn_proj = 8
    exp.model.rnn_state_size = 4
    exp.schedule.max_steps = 4
    for key in ("steps_per_logprint", "steps_per_checkpoint",
                "steps_per_validation", "steps_per_evaluation"):
        setattr(exp.schedule, key, 100)
    model = registry.create_model("gaze_grcn77", exp.model, device="cpu")
    data = synthetic.make_splits(n_train=8, n_valid=0, n_test=0, t=3,
                                 gazemap_hw=(7, 7))
    state, tx = create_train_state(model, exp.optimizer)
    loader = grain_pipeline.make_dataloader(data.train, batch_size=2,
                                            num_epochs=2)
    state = fit(model, state, tx, data, exp,
                train_iterator=grain_pipeline.iterate_batches(loader))
    assert int(state.step) == 4


# -------------------------------------------------------------------- native


def test_native_libraries_build():
    assert native.build_status() == {"blobio": "built",
                                     "framedec": "built"}
    assert native.available() and native.framedec_available()


def test_native_blob_codec_matches_numpy(tmp_path):
    rng = np.random.RandomState(0)
    blob = rng.rand(1, 512, 2, 7, 7).astype(np.float32)
    path = str(tmp_path / "a.conv5b")
    codec.write_binary_blob(path, blob)
    np.testing.assert_array_equal(native.read_blob(path), blob)
    other = rng.rand(2, 3, 4, 5, 6).astype(np.float32)
    native.write_blob(str(tmp_path / "b.blob"), other)
    np.testing.assert_array_equal(
        codec.read_binary_blob(str(tmp_path / "b.blob")), other)
    with open(path, "rb") as a, open(str(tmp_path / "c.blob"), "wb") as b:
        native.write_blob(b.name, blob)
        assert a.read() == open(b.name, "rb").read()


def test_native_blob_batch_read(tmp_path):
    rng = np.random.RandomState(2)
    shape = (1, 512, 2, 7, 7)
    paths, blobs = [], []
    for i in range(20):
        blobs.append(rng.rand(*shape).astype(np.float32))
        paths.append(str(tmp_path / f"w{i:03d}.conv5b"))
        codec.write_binary_blob(paths[-1], blobs[-1])
    np.testing.assert_array_equal(native.read_blob_batch(paths, shape,
                                                         n_threads=4),
                                  np.stack(blobs))
    with pytest.raises(IOError, match="failures"):
        native.read_blob_batch([paths[0], str(tmp_path / "missing")], shape)


def _jpeg_folder(folder, n=5, hw=(60, 80), seed=0):
    rng = np.random.RandomState(seed)
    folder.mkdir()
    for i in range(n):
        Image.fromarray(rng.randint(0, 255, (*hw, 3)).astype(
            np.uint8)).save(folder / f"{i:06d}.jpg", quality=95)
    return sorted(str(p) for p in folder.iterdir())


def test_native_jpeg_decoder_matches_pil(tmp_path):
    paths = _jpeg_folder(tmp_path / "f")
    pil = np.stack([np.asarray(Image.open(p).convert("RGB"))
                    for p in paths])
    np.testing.assert_array_equal(native.decode_jpeg_batch(paths, (60, 80)),
                                  pil)
    resized = native.decode_jpeg_batch(paths, (98, 98))
    pil_r = np.stack([np.asarray(Image.open(p).convert("RGB").resize(
        (98, 98), Image.BILINEAR)) for p in paths])
    assert np.abs(resized.astype(int) - pil_r.astype(int)).max() <= 2
    np.testing.assert_array_equal(resized,
                                  jnative.decode_jpeg_batch(paths, (98, 98)))
    with pytest.raises(IOError, match="failures"):
        native.decode_jpeg_batch([paths[0], str(tmp_path / "no.jpg")],
                                 (60, 80))


@pytest.mark.parametrize("hw", [(60, 80), (49, 49)])
def test_load_frame_folder_native_matches_jax(tmp_path, hw):
    folder = tmp_path / "frames"
    _jpeg_folder(folder, n=4, seed=1)
    got = video.load_frame_folder(str(folder), hw, backend="native")
    np.testing.assert_array_equal(
        got, jvideo.load_frame_folder(str(folder), hw, backend="native"))
    if hw == (60, 80):  # decode only: PIL's bits
        np.testing.assert_array_equal(
            got, video.load_frame_folder(str(folder), hw))


def test_native_falls_back_without_a_compiler(tmp_path, monkeypatch):
    """No library: the blob reader falls back to the NumPy codec and the
    decoder to PIL, and `build_status` says why."""
    monkeypatch.setattr(native, "_loaded", {})
    monkeypatch.setattr(native, "_reasons", {})
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    status = native.build_status()
    assert all(s.startswith("fallback (") for s in status.values()), status
    blob = np.random.RandomState(3).rand(1, 2, 2, 2, 2).astype(np.float32)
    path = str(tmp_path / "x.blob")
    native.write_blob(path, blob)
    np.testing.assert_array_equal(native.read_blob(path), blob)
    paths = _jpeg_folder(tmp_path / "f", n=2)
    np.testing.assert_array_equal(
        native.decode_jpeg_batch(paths, (60, 80)),
        np.stack([np.asarray(Image.open(p).convert("RGB")) for p in paths]))
    assert os.path.exists(path)
