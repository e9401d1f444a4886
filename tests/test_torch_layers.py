"""The port's layers, normalizers and initializers against the JAX package
on the CPU. Inputs come from numpy with a seed and go through both.

Tolerances: f32 ops rtol 1e-4 / atol 1e-5 (summation order only, the JAX
package's own kernel tolerance); bf16 convs return their result rounded to
bf16 in both packages, so they may differ by one bf16 ulp (2^-8 relative)
where the f32 sums round differently: rtol 1e-2 / atol 1e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recurrent_gaze_prediction_tpu.ops import layers as jl
from recurrent_gaze_prediction_tpu.ops import normalize as jn
from recurrent_gaze_prediction_tpu_torch.ops import initializers as ti
from recurrent_gaze_prediction_tpu_torch.ops import layers as tl
from recurrent_gaze_prediction_tpu_torch.ops import normalize as tn

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=1e-2, atol=1e-2)


def _arr(rng, *shape, positive=False):
    a = rng.randn(*shape).astype(np.float32)
    return np.abs(a) + 0.1 if positive else a


def _conv(rng, stride, padding, cdt):
    x, k = _arr(rng, 2, 9, 9, 6), _arr(rng, 3, 3, 6, 5) * 0.3
    j = jl.conv2d(jnp.asarray(x), jnp.asarray(k), stride=stride,
                  padding=padding,
                  compute_dtype=None if cdt is None else jnp.dtype(cdt))
    t = tl.conv2d(torch.from_numpy(x), torch.from_numpy(k), stride=stride,
                  padding=padding,
                  compute_dtype=None if cdt is None else getattr(torch, cdt))
    return j, t, F32 if cdt is None else BF16


def _deconv(rng, k, stride, padding, size):
    x, w = _arr(rng, 2, size, size, 4), _arr(rng, k, k, 4, 3) * 0.3
    j = jl.conv2d_transpose(jnp.asarray(x), jnp.asarray(w), stride=stride,
                            padding=padding)
    t = tl.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w),
                            stride=stride, padding=padding)
    return j, t, F32


def _deconv_bf16(rng):
    x, w = _arr(rng, 2, 7, 7, 4), _arr(rng, 5, 5, 4, 3) * 0.3
    j = jl.conv2d_transpose(jnp.asarray(x), jnp.asarray(w), stride=3,
                            compute_dtype=jnp.bfloat16)
    t = tl.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w),
                            stride=3, compute_dtype=torch.bfloat16)
    return j, t, BF16


def _pool(rng, fn, hw, window, stride, padding):
    """max_pool2d / avg_pool2d with the JAX package's SAME (the extra pad on
    the high side) on odd and even sizes."""
    x = _arr(rng, 2, *hw, 3)
    j = getattr(jl, fn)(jnp.asarray(x), window, stride, padding)
    t = getattr(tl, fn)(torch.from_numpy(x), window, stride, padding)
    return j, t, F32


def _maxout(rng):
    x = _arr(rng, 4, 10)
    return jl.maxout2(jnp.asarray(x)), tl.maxout2(torch.from_numpy(x)), F32


def _frozen_bn(rng):
    x, s, o = _arr(rng, 3, 7, 7, 5), _arr(rng, 5), _arr(rng, 5)
    j = jl.frozen_batch_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(o))
    t = tl.frozen_batch_norm(*map(torch.from_numpy, (x, s, o)))
    return j, t, F32


def _linear(rng, cdt, out_dtype):
    x, w, b = _arr(rng, 10, 16), _arr(rng, 16, 8), _arr(rng, 8)
    jc = None if cdt is None else jnp.dtype(cdt)
    tc = None if cdt is None else getattr(torch, cdt)
    j = jl.linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                  compute_dtype=jc, out_dtype=out_dtype and jnp.dtype(out_dtype))
    t = tl.linear(*map(torch.from_numpy, (x, w, b)), compute_dtype=tc,
                  out_dtype=out_dtype and getattr(torch, out_dtype))
    return j, t, F32 if out_dtype is None else BF16


def _normalize(rng, name):
    maps = _arr(rng, 2, 3, 7, 9, positive=name != "softmax_2d")
    args = [maps]
    if name in ("softmax_cross_entropy_2d", "kl_divergence_2d"):
        labels = _arr(rng, 2, 3, 7, 9, positive=True)
        labels /= labels.sum(axis=(-2, -1), keepdims=True)
        if name == "kl_divergence_2d":
            maps = maps / maps.sum(axis=(-2, -1), keepdims=True)
            args = [maps]
        args.append(labels)
    if name == "normalize_map":  # include a constant map (guarded divide)
        args[0][0, 0] = 3.0
    j = getattr(jn, name)(*map(jnp.asarray, args))
    t = getattr(tn, name)(*map(torch.from_numpy, args))
    return j, t, F32


CASES = {
    "conv_same_s1": lambda r: _conv(r, 1, "SAME", None),
    "conv_same_s2": lambda r: _conv(r, 2, "SAME", None),
    "conv_valid_s1": lambda r: _conv(r, 1, "VALID", None),
    "conv_same_bf16": lambda r: _conv(r, 1, "SAME", "bfloat16"),
    "deconv_k5_s3_valid": lambda r: _deconv(r, 5, 3, "VALID", 7),
    "deconv_k5_s2_valid": lambda r: _deconv(r, 5, 2, "VALID", 23),
    "deconv_k7_s1_same": lambda r: _deconv(r, 7, 1, "SAME", 11),
    "deconv_k5_s3_valid_bf16": _deconv_bf16,
    # the cascade's upsample: 11x11 stride 7 SAME, 7 -> 49
    "deconv_k11_s7_same": lambda r: _deconv(r, 11, 7, "SAME", 7),
    "max_pool_same_odd": lambda r: _pool(r, "max_pool2d", (11, 9), 3, 2,
                                         "SAME"),
    "max_pool_same_shallownet": lambda r: _pool(r, "max_pool2d", (45, 45),
                                                3, 2, "SAME"),
    "max_pool_same_even": lambda r: _pool(r, "max_pool2d", (94, 94), 2, 2,
                                          "SAME"),
    "max_pool_valid": lambda r: _pool(r, "max_pool2d", (10, 9), 3, 2,
                                      "VALID"),
    "avg_pool_valid_7x7": lambda r: _pool(r, "avg_pool2d", (49, 49), 7, 7,
                                          "VALID"),
    "avg_pool_same_odd": lambda r: _pool(r, "avg_pool2d", (11, 9), 3, 2,
                                         "SAME"),
    "maxout2": _maxout,
    "frozen_batch_norm": _frozen_bn,
    "linear_f32": lambda r: _linear(r, None, None),
    "linear_bf16_f32acc": lambda r: _linear(r, "bfloat16", None),
    "linear_bf16_out": lambda r: _linear(r, "bfloat16", "bfloat16"),
    **{name: (lambda r, n=name: _normalize(r, n)) for name in (
        "normalize_map", "normalize_probability_map", "softmax_2d",
        "softmax_cross_entropy_2d", "kl_divergence_2d")},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_matches_jax(case):
    j, t, tol = CASES[case](np.random.RandomState(0))
    j = np.asarray(jnp.asarray(j, jnp.float32))
    t = t.float().numpy()
    assert j.shape == t.shape
    np.testing.assert_allclose(t, j, **tol)


@pytest.mark.parametrize("init", ["truncated_normal", "xavier_uniform",
                                  "uniform_scale"])
def test_initializer_range_and_seed(init):
    """Same recipe as the JAX initializers: truncated normal within 2
    sigma, Xavier within sqrt(6/(fan_in+fan_out)), uniform within scale;
    the same generator seed gives the same tensor."""
    shape = (3, 3, 64, 32)
    fn = getattr(ti, init)
    draw = lambda: fn(shape, generator=torch.Generator().manual_seed(5))
    a = draw()
    assert torch.equal(a, draw()) and a.shape == shape
    limit = {"truncated_normal": 2e-4,
             "xavier_uniform": (6.0 / (9 * 64 + 9 * 32)) ** 0.5,
             "uniform_scale": 0.1}[init]
    assert float(a.abs().max()) <= limit
    if init == "truncated_normal":  # std of N(0,1) truncated at 2 sigma
        assert abs(float(a.std()) / 1e-4 - 0.8796) < 0.02
