"""The C3D tower, its layers, preprocessing and weight ingestion: the port
against the JAX package on the CPU, in f32, with the same weights and
inputs made from a seed with numpy and carried across by the bridge.

Layers at rtol 1e-4 / atol 1e-5; preprocessing at atol 1e-3 on the 0..255
scale; the tower at each feature layer at max |delta| <= 1e-4 * max |JAX|;
the folds, window starts and Caffe ingestion exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recurrent_gaze_prediction_tpu.compat import caffemodel as jcaffe
from recurrent_gaze_prediction_tpu.models import c3d as jc3d
from recurrent_gaze_prediction_tpu.ops import layers as jlayers
from recurrent_gaze_prediction_tpu_torch.bridge import (c3d_params_from_jax,
                                                        c3d_params_to_jax)
from recurrent_gaze_prediction_tpu_torch.compat import caffemodel as caffe
from recurrent_gaze_prediction_tpu_torch.models import c3d
from recurrent_gaze_prediction_tpu_torch.ops import layers


def jax_c3d_params(seed: int = 0, fc: bool = True) -> dict:
    """C3D weights in the JAX layout with He-scaled random values, so the
    activations keep their size through all eight convs. fc=False makes
    the fc layers 8x8 placeholders: paths that stop at conv5b never read
    them, and their full 52M weights take seconds to draw."""
    rng = np.random.RandomState(seed)
    params = {}
    in_ch = 3
    for name, out_ch in jc3d.CONV_LAYERS:
        params[f"{name}_w"] = (rng.randn(3, 3, 3, in_ch, out_ch)
                               * np.sqrt(2.0 / (27 * in_ch))).astype(
                                   np.float32)
        params[f"{name}_b"] = (rng.randn(out_ch) * 0.1).astype(np.float32)
        in_ch = out_ch
    fc_layers = jc3d.FC_LAYERS if fc else [(n, 8, 8) for n, _, _ in
                                           jc3d.FC_LAYERS]
    for name, d_in, d_out in fc_layers:
        params[f"{name}_w"] = (rng.randn(d_in, d_out)
                               * np.sqrt(2.0 / d_in)).astype(np.float32)
        params[f"{name}_b"] = (rng.randn(d_out) * 0.1).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def weights():
    jparams = jax_c3d_params()
    return jparams, c3d_params_from_jax(jparams)


def _ncdhw(a) -> np.ndarray:
    return np.transpose(np.asarray(a), (0, 4, 1, 2, 3))


@pytest.mark.parametrize("padding,stride", [("SAME", (1, 1, 1)),
                                            ("VALID", (1, 1, 1)),
                                            ("SAME", (2, 2, 2)),
                                            ("SAME", (1, 2, 3))])
def test_conv3d_matches_jax(padding, stride):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 9, 8, 6).astype(np.float32)       # NDHWC
    w = rng.randn(3, 3, 3, 6, 4).astype(np.float32)       # DHWIO
    b = rng.randn(4).astype(np.float32)
    want = np.asarray(jlayers.conv3d(jnp.asarray(x), jnp.asarray(w),
                                     stride=stride, padding=padding)) + b
    got = layers.conv3d(torch.from_numpy(_ncdhw(x).copy()),
                        torch.from_numpy(np.transpose(w, (4, 3, 0, 1, 2))
                                         .copy()),
                        torch.from_numpy(b), stride=stride, padding=padding)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _ncdhw(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("shape,window,stride", [
    ((2, 7, 7), (2, 2, 2), (2, 2, 2)),    # pool5: one-sided SAME pad
    ((16, 12, 10), (1, 2, 2), (1, 2, 2)),  # pool1
    ((5, 9, 6), (2, 2, 2), (2, 2, 2)),    # odd sizes on every axis
    ((4, 6, 6), (3, 3, 3), (2, 2, 2)),
])
def test_max_pool3d_matches_jax(shape, window, stride):
    x = np.random.RandomState(2).randn(2, *shape, 5).astype(np.float32)
    want = np.asarray(jlayers.max_pool3d(jnp.asarray(x), window, stride,
                                         padding="SAME"))
    got = layers.max_pool3d(torch.from_numpy(_ncdhw(x).copy()), window,
                            stride)
    assert got.shape == _ncdhw(want).shape
    np.testing.assert_allclose(got.numpy(), _ncdhw(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("hw,bgr,cube", [((64, 80), False, False),
                                         ((240, 320), True, True),
                                         ((128, 171), False, True)])
def test_preprocess_frames_matches_jax(hw, bgr, cube):
    rng = np.random.RandomState(3)
    frames = rng.randint(0, 256, (1, 16, *hw, 3)).astype(np.uint8)
    mean = (rng.rand(16, 112, 112, 3) * 255).astype(np.float32) \
        if cube else None
    want = np.asarray(jc3d.preprocess_frames(
        jnp.asarray(frames), None if mean is None else jnp.asarray(mean),
        bgr=bgr))
    got = c3d.preprocess_frames(torch.from_numpy(frames), mean, bgr=bgr)
    assert got.shape == (1, 3, 16, 112, 112) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _ncdhw(want), rtol=0, atol=1e-3)


def test_folds_windows_and_caffe_arrays_are_exact(weights):
    jparams, params = weights
    rng = np.random.RandomState(4)
    feats = rng.randn(3, 2, 7, 7, 512).astype(np.float32)
    np.testing.assert_array_equal(
        c3d.conv5b_to_rgp(torch.from_numpy(_ncdhw(feats).copy())).numpy(),
        np.asarray(jc3d.conv5b_to_rgp(jnp.asarray(feats))))

    mean = rng.rand(16, 112, 112, 3).astype(np.float32)
    jfold, jmean = jc3d.fold_bgr_into_params(jparams, mean)
    fold, fmean = c3d.fold_bgr_into_params(params, mean)
    for k, v in c3d_params_to_jax(fold).items():
        np.testing.assert_array_equal(v, np.asarray(jfold[k]), err_msg=k)
    np.testing.assert_array_equal(fmean.numpy(), np.asarray(jmean))
    assert c3d.fold_bgr_into_params(params).keys() == params.keys()

    for f in (0, 15, 16, 17, 160):
        assert c3d.clip_windows(f) == jc3d.clip_windows(f)

    arrays = {}
    in_ch = 3
    for name, out_ch in c3d.CONV_LAYERS:
        arrays[name] = {"w": rng.randn(out_ch, in_ch, 3, 3, 3),
                        "b": rng.randn(out_ch)}
        in_ch = out_ch
    for name, _, _ in c3d.FC_LAYERS:  # narrow: no width is checked
        arrays[f"{name}-1"] = (rng.randn(48, 32), rng.randn(48))
    arrays = {k: ({n: a.astype(np.float32) for n, a in v.items()}
                  if isinstance(v, dict) else tuple(a.astype(np.float32)
                                                    for a in v))
              for k, v in arrays.items()}
    ours = c3d_params_to_jax(c3d.params_from_caffe_arrays(arrays))
    theirs = jc3d.params_from_caffe_arrays(arrays)
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], np.asarray(theirs[k]),
                                      err_msg=k)


def _flat_nc(a) -> np.ndarray:
    """A JAX feature in the port's layout: NDHWC -> NCDHW where 5-D."""
    a = np.asarray(a)
    return _ncdhw(a) if a.ndim == 5 else a


@pytest.mark.parametrize("feature_layer", c3d.FEATURE_LAYERS)
def test_tower_matches_jax_at_each_feature_layer(weights, feature_layer):
    jparams, params = weights
    pixels = np.random.RandomState(5).randint(
        0, 256, (1, 16, 128, 171, 3)).astype(np.uint8)
    jclips = jc3d.preprocess_frames(jnp.asarray(pixels))
    want = _flat_nc(jc3d.apply({k: jnp.asarray(v) for k, v in
                                jparams.items()}, jclips,
                               feature_layer=feature_layer))
    with torch.no_grad():
        got = c3d.apply(params, c3d.preprocess_frames(
            torch.from_numpy(pixels)), feature_layer=feature_layer).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got - want).max() <= 1e-4 * scale, feature_layer


def _caffe_layers(layout: str, seed: int, fc_width: int = 64) -> dict:
    """The two `.caffemodel` fixtures of tests/test_compat.py, with their
    layer names and blob layouts and the convs at the full Sports-1M
    shapes: "roundtrip" (:202) with [1,1,1,1,out] biases and fc blobs
    [out,in,1,1,1]; "v1_full" (:1126) with fc blobs in the V1-era
    [1,1,1,out,in] layout. The fc blobs are `fc_width` square (their full
    widths, 8192x4096 and up, only make the files slow to write; the
    ingestion does not read a width)."""
    rng = np.random.RandomState(seed)
    layers_ = {}
    in_ch = 3
    for name, out_ch in c3d.CONV_LAYERS:
        layers_[name] = [
            (rng.randn(out_ch, in_ch, 3, 3, 3) * 0.05).astype(np.float32),
            rng.randn(1, 1, 1, 1, out_ch).astype(np.float32)]
        in_ch = out_ch
    for name, _, _ in c3d.FC_LAYERS:
        d_in = d_out = fc_width
        w = (rng.randn(d_out, d_in) * 0.01).astype(np.float32)
        w = (w.reshape(d_out, d_in, 1, 1, 1) if layout == "roundtrip"
             else w.reshape(1, 1, 1, d_out, d_in))
        layers_[f"{name}-1"] = [w, rng.randn(1, 1, 1, 1, d_out).astype(
            np.float32)]
    return layers_


@pytest.mark.parametrize("layout,writer", [("roundtrip", "jax"),
                                           ("v1_full", "port")])
def test_caffemodel_written_by_one_package_reads_in_the_other(
        tmp_path, layout, writer):
    layers_ = _caffe_layers(layout, seed=6)
    path = str(tmp_path / "sports1m.caffemodel")
    (jcaffe if writer == "jax" else caffe).write_caffemodel(path, layers_)
    parsed = caffe.parse_caffemodel(path)
    assert set(parsed) == set(layers_)
    for name, blobs in layers_.items():
        for got, want in zip(parsed[name], blobs):
            np.testing.assert_array_equal(got, want, err_msg=name)
    ours = c3d_params_to_jax(caffe.c3d_params_from_caffemodel(path))
    theirs = jcaffe.c3d_params_from_caffemodel(path)
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], np.asarray(theirs[k]),
                                      err_msg=k)
