"""The port's peephole ConvLSTM (the cell, and kernel B3's plain version as
the wrapper runs it on a CPU tensor) against the JAX package's
`ConvLSTM` and its Pallas kernel in interpret mode, on the CPU, with
nonzero carries.

f32 runs at rtol 1e-4 / atol 1e-5, the JAX package's own kernel tolerance
(tests/test_pallas.py). bf16 rounds the state conv's operand and result to
bf16 in both packages; single-ulp flips where the f32 sums round
differently grow over the recurrence (through c as well as h), so bf16 is
held to max |delta| <= 2e-2 of the state scale and corr >= 0.9999, the
ConvGRU test's bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recurrent_gaze_prediction_tpu.ops.cells import ConvLSTM as JConvLSTM
from recurrent_gaze_prediction_tpu.ops.pallas.convlstm import (
    convlstm_scan_pallas as j_convlstm_scan_pallas)
from recurrent_gaze_prediction_tpu_torch.ops.cells import ConvLSTM
from recurrent_gaze_prediction_tpu_torch.ops.kernels import convlstm as klstm
from recurrent_gaze_prediction_tpu_torch.ops.kernels.parity import (
    convlstm_parity, parity_ok)

T, B, C, U = 3, 2, 8, 8


def _inputs(seed=0, scale=0.3):
    rng = np.random.RandomState(seed)
    shapes = {k: v.shape for k, v in ConvLSTM.init(C, U).items()}
    params = {k: (rng.randn(*s) * scale).astype(np.float32)
              for k, s in shapes.items()}
    xs = rng.randn(T, B, 7, 7, C).astype(np.float32)
    carry = tuple((rng.randn(B, 7, 7, U) * 0.5).astype(np.float32)
                  for _ in range(2))
    return params, xs, carry


def _torch(params, xs, carry):
    return ({k: torch.from_numpy(v) for k, v in params.items()},
            torch.from_numpy(xs), tuple(map(torch.from_numpy, carry)))


def _jax(params, xs, carry):
    return ({k: jnp.asarray(v) for k, v in params.items()},
            jnp.asarray(xs), tuple(map(jnp.asarray, carry)))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


def test_step_matches_jax_f32():
    params, xs, carry = _inputs()
    tp, tx, tc = _torch(params, xs, carry)
    (c_t, h_t), y_t = ConvLSTM.step(ConvLSTM.fuse(tp), tc, tx[0])
    jp, jx, jc = _jax(params, xs, carry)
    (c_j, h_j), y_j = JConvLSTM.step(JConvLSTM.fuse(jp), jc, jx[0])
    _close(c_t, c_j)
    _close(h_t, h_j)
    _close(y_t, y_j)


def test_scan_matches_jax_f32():
    inputs = _inputs(seed=1)
    (c_t, h_t), ys_t = ConvLSTM.scan(*_torch(*inputs),
                                     compute_dtype=torch.float32)
    (c_j, h_j), ys_j = JConvLSTM.scan(*_jax(*inputs),
                                      compute_dtype=jnp.float32)
    _close(ys_t, ys_j)
    _close(c_t, c_j)
    _close(h_t, h_j)


def test_kernel_plain_version_matches_jax_pallas_interpret():
    """B3's plain version (the wrapper on a CPU tensor) against the Pallas
    kernel in interpret mode on the same precomputed gates, f32."""
    params, _, carry = _inputs(seed=2)
    gx = np.random.RandomState(3).randn(T, B, 7, 7, 4 * U).astype(np.float32)
    tparams, _, tcarry = _torch(params, gx, carry)
    (c_t, h_t), ys_t = klstm.convlstm_recurrence(
        ConvLSTM.fuse(tparams), torch.from_numpy(gx), *tcarry)
    jp, _, (c0, h0) = _jax(params, gx, carry)
    ys_j = j_convlstm_scan_pallas(jp, jnp.asarray(gx), c0, h0,
                                  interpret=True)
    _close(ys_t, ys_j)
    _close(h_t, np.asarray(ys_j)[-1])
    # the Pallas kernel keeps c_T to itself; the JAX scan returns it
    (c_j, _), _ = jax.lax.scan(
        lambda cr, g: JConvLSTM.step_precomputed(JConvLSTM.fuse(jp), cr, g),
        (c0, h0), jnp.asarray(gx))
    _close(c_t, c_j)


def test_scan_matches_jax_bf16():
    inputs = _inputs(seed=4)
    (c_t, _), ys_t = ConvLSTM.scan(*_torch(*inputs),
                                   compute_dtype=torch.bfloat16)
    (c_j, _), ys_j = jax.jit(lambda p, x, cr: JConvLSTM.scan(
        p, x, cr, compute_dtype=jnp.bfloat16))(*_jax(*inputs))
    for got, want in ((ys_t, ys_j), (c_t, c_j)):
        a, t = np.asarray(want, np.float32), got.float().numpy()
        assert np.abs(a - t).max() <= 2e-2 * np.abs(a).max()
        assert np.corrcoef(a.ravel(), t.ravel())[0, 1] >= 0.9999


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_wrapper_on_cpu_is_the_plain_scan(dtype):
    """On a CPU tensor the wrapper runs the plain version, returns the
    final (c, h), and counts no kernel launch."""
    params, xs, carry = _torch(*_inputs(seed=5))
    before = klstm.launches
    (c_k, h_k), ys_k = klstm.convlstm_scan(params, xs, carry,
                                           compute_dtype=dtype)
    (c_p, h_p), ys_p = ConvLSTM.scan(params, xs, carry, compute_dtype=dtype)
    assert klstm.launches == before
    assert torch.equal(ys_k, ys_p) and torch.equal(h_k, h_p)
    assert torch.equal(c_k, c_p) and torch.equal(h_k, ys_k[-1])


def _bad(case):
    params, xs, (c0, h0) = _torch(*_inputs(seed=6))
    fused = ConvLSTM.fuse(params)
    gx = torch.zeros(T, B, 7, 7, 4 * U)
    if case == "rank":
        gx = gx[0]
    elif case == "not_4u":
        gx = torch.zeros(T, B, 7, 7, 4 * U + 2)
    elif case == "dtype":
        gx = gx.half()
    elif case == "carry":
        c0 = c0[:, :, :6]
    elif case == "peephole":
        fused["W_cf"] = fused["W_cf"][:6]
    elif case == "weight":
        fused["Wh"] = fused["Wh"][..., :3 * U]
    return fused, gx, c0, h0


@pytest.mark.parametrize("case", ["rank", "not_4u", "dtype", "carry",
                                  "peephole", "weight"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    with pytest.raises(ValueError):
        klstm.convlstm_recurrence(*_bad(case))


def test_step_precomputed_matches_per_gate_equations():
    """The fused two-conv step equals the eight-conv gate equations, with
    the candidate on W_hc and the output gate on the old c."""
    from recurrent_gaze_prediction_tpu_torch.ops.layers import conv2d

    p, xs, (c, h) = _torch(*_inputs(seed=7))
    x = xs[0]

    def pre(g):
        return conv2d(x, p[f"W_x{g}"]) + conv2d(h, p[f"W_h{g}"])

    i = torch.sigmoid(pre("i") + p["W_ci"] * c)
    f = torch.sigmoid(pre("f") + p["W_cf"] * c)
    want_c = f * c + i * torch.tanh(pre("c"))
    want_h = torch.tanh(want_c) * torch.sigmoid(pre("o") + p["W_co"] * c)
    fused = ConvLSTM.fuse(p)
    (got_c, got_h), _ = ConvLSTM.step_precomputed(
        fused, (c, h), conv2d(x, fused["Wx"]))
    for got, want in ((got_c, want_c), (got_h, want_h)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_parity_harness_runs_on_cpu():
    """On the CPU both sides of `convlstm_parity` are the plain scan; this
    pins the harness itself (shapes, stats, the final_c report, the
    gate)."""
    stats = convlstm_parity(t=2, b=2, c=8, units=16, device="cpu")
    assert stats["corr"] == pytest.approx(1.0) and parity_ok(stats)
    assert stats["final_c"]["max_delta"] == 0.0
    assert stats["final_h_max_delta"] == 0.0
    assert stats["shape"] == {"t": 2, "b": 2, "h": 7, "w": 7, "c": 8,
                              "units": 16}
    assert not parity_ok(dict(stats, final_c=dict(stats["final_c"],
                                                  corr=0.5)))
