"""The port's ConvGRU scan (the CUDA kernel's plain version, and the
kernel's wrapper on a CPU tensor) against the JAX package's `ConvGRU.scan`
and its Pallas kernel in interpret mode, on the CPU.

f32 runs at rtol 1e-4 / atol 1e-5, the JAX package's own kernel tolerance
(tests/test_pallas.py). bf16 rounds each conv result to bf16 in both
packages; single-ulp flips where the f32 sums round differently grow over
the recurrence, so bf16 is held to max |delta| <= 2e-2 of the state scale
and corr >= 0.9999.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recurrent_gaze_prediction_tpu.ops.cells import ConvGRU as JConvGRU
from recurrent_gaze_prediction_tpu.ops.pallas.convgru import (
    convgru_scan as j_convgru_scan)
from recurrent_gaze_prediction_tpu_torch.ops.cells import ConvGRU
from recurrent_gaze_prediction_tpu_torch.ops.kernels import convgru as kconv
from recurrent_gaze_prediction_tpu_torch.ops.kernels.parity import (
    convgru_parity, parity_ok)

T, B, C, U = 3, 2, 8, 8


def _inputs(seed=0, scale=0.3):
    rng = np.random.RandomState(seed)
    shapes = {k: v.shape for k, v in ConvGRU.init(C, U).items()}
    params = {k: (rng.randn(*s) * scale).astype(np.float32)
              for k, s in shapes.items()}
    xs = rng.randn(T, B, 7, 7, C).astype(np.float32)
    h0 = (rng.randn(B, 7, 7, U) * 0.5).astype(np.float32)
    return params, xs, h0


def _torch(params, xs, h0):
    return ({k: torch.from_numpy(v) for k, v in params.items()},
            torch.from_numpy(xs), torch.from_numpy(h0))


def _jax(params, xs, h0):
    return ({k: jnp.asarray(v) for k, v in params.items()},
            jnp.asarray(xs), jnp.asarray(h0))


@pytest.mark.parametrize("reference", ["jax_scan", "jax_pallas_interpret"])
def test_plain_scan_matches_jax_f32(reference):
    inputs = _inputs()
    h_t, ys_t = ConvGRU.scan(*_torch(*inputs), compute_dtype=torch.float32)
    if reference == "jax_scan":
        h_j, ys_j = JConvGRU.scan(*_jax(*inputs), compute_dtype=jnp.float32)
    else:
        h_j, ys_j = j_convgru_scan(*_jax(*inputs), compute_dtype=jnp.float32,
                                   interpret=True)
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j),
                               rtol=1e-4, atol=1e-5)


def test_plain_scan_matches_jax_bf16():
    inputs = _inputs(seed=1)
    _, ys_t = ConvGRU.scan(*_torch(*inputs), compute_dtype=torch.bfloat16)
    _, ys_j = jax.jit(lambda p, x, h: JConvGRU.scan(
        p, x, h, compute_dtype=jnp.bfloat16))(*_jax(*inputs))
    a, t = np.asarray(ys_j, np.float32), ys_t.float().numpy()
    assert np.abs(a - t).max() <= 2e-2 * np.abs(a).max()
    assert np.corrcoef(a.ravel(), t.ravel())[0, 1] >= 0.9999


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_wrapper_on_cpu_is_the_plain_scan(dtype):
    """On a CPU tensor the wrapper runs the plain version and counts no
    kernel launch."""
    params, xs, h0 = _torch(*_inputs(seed=2))
    before = kconv.launches
    h_k, ys_k = kconv.convgru_scan(params, xs, h0, compute_dtype=dtype)
    h_p, ys_p = ConvGRU.scan(params, xs, h0, compute_dtype=dtype)
    assert kconv.launches == before
    assert torch.equal(ys_k, ys_p) and torch.equal(h_k, h_p)
    assert torch.equal(h_k, ys_k[-1])


def test_step_precomputed_matches_per_gate_equations():
    """The fused three-conv step equals the six-conv gate equations."""
    from recurrent_gaze_prediction_tpu_torch.ops.layers import conv2d

    params, xs, h0 = _torch(*_inputs(seed=3))
    x, h = xs[0], h0
    u = torch.sigmoid(conv2d(x, params["W_z"]) + conv2d(h, params["U_z"]))
    r = torch.sigmoid(conv2d(x, params["W_r"]) + conv2d(h, params["U_r"]))
    c = torch.tanh(conv2d(x, params["W"]) + conv2d(r * h, params["U"]))
    want = u * h + (1 - u) * c
    fused = ConvGRU.fuse(params)
    got, _ = ConvGRU.step_precomputed(
        fused, h, conv2d(x, fused["Wx_zrc"]))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_parity_harness_runs_on_cpu():
    """On the CPU both sides of `convgru_parity` are the plain scan; this
    pins the harness itself (shapes, stats, the gate)."""
    stats = convgru_parity(t=2, b=2, c=8, units=16, device="cpu")
    assert stats["corr"] == pytest.approx(1.0) and parity_ok(stats)
    assert stats["shape"] == {"t": 2, "b": 2, "h": 7, "w": 7, "c": 8,
                              "units": 16}
