"""The port's ConvGRU backward (plain versions of kernels B2 and B4, B4's
three-phase composition, and the autograd Function around it, run by both
JAX entry points) against the JAX package on the CPU.

The plain versions are held against the JAX Pallas kernels in interpret
mode (`_dh_bwd_pallas`, `_convgru_bwd_pallas`) at rtol 1e-4 / atol 1e-5, the
JAX package's kernel tolerance. The Functions' loss and gradients are held
against `jax.value_and_grad` of the JAX `ConvGRU.scan` at its gradient
tolerance, rtol 1e-3 / atol 1e-5 (tests/test_pallas.py). All in f32, cell
weights scaled x0.3 so the recurrence matters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recurrent_gaze_prediction_tpu.ops.cells import ConvGRU as JConvGRU
from recurrent_gaze_prediction_tpu.ops.pallas import convgru_vjp as jv1
from recurrent_gaze_prediction_tpu.ops.pallas import convgru_vjp2 as jv2
from recurrent_gaze_prediction_tpu_torch.ops.cells import ConvGRU
from recurrent_gaze_prediction_tpu_torch.ops.kernels import convgru as kconv
from recurrent_gaze_prediction_tpu_torch.ops.kernels import convgru_vjp as v1
from recurrent_gaze_prediction_tpu_torch.ops.kernels import convgru_vjp2 as v2

TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)


def _f32(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _weights(rng, units):
    return (_f32(rng, 3, 3, units, 2 * units, scale=0.3),
            _f32(rng, 3, 3, units, units, scale=0.3))


def _assert_all_close(torch_out, jax_out, tol=TOL):
    assert len(torch_out) == len(jax_out)
    for i, (t, j) in enumerate(zip(torch_out, jax_out)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=str(i),
                                   **tol)


def test_dh_bwd_plain_matches_jax_kernel_interpret():
    rng = np.random.RandomState(0)
    t, b, units = 3, 1, 4
    shape = (t, b, 7, 7, units)
    u, r = (1 / (1 + np.exp(-_f32(rng, *shape))) for _ in range(2))
    c = np.tanh(_f32(rng, *shape))
    hprev, g = _f32(rng, *shape, scale=0.5), _f32(rng, *shape)
    arrays = [x.astype(np.float32) for x in (u, r, c, hprev, g)]
    arrays += _weights(rng, units)
    want = jv2._dh_bwd_pallas(*map(jnp.asarray, arrays), interpret=True)
    got = v2.dh_bwd_plain(*map(torch.from_numpy, arrays))
    _assert_all_close(got, want)


def test_convgru_bwd_plain_matches_jax_kernel_interpret():
    rng = np.random.RandomState(1)
    t, b, units = 3, 1, 4
    uzr, uc = _weights(rng, units)
    wx = _f32(rng, t, b, 7, 7, 3 * units)
    ys = _f32(rng, t, b, 7, 7, units, scale=0.5)
    h0 = _f32(rng, b, 7, 7, units, scale=0.5)
    g = _f32(rng, t, b, 7, 7, units)
    arrays = (uzr, uc, wx, ys, h0, g)
    want = jv1._convgru_bwd_pallas(*map(jnp.asarray, arrays), interpret=True)
    got = v1.convgru_bwd_plain(*map(torch.from_numpy, arrays))
    _assert_all_close(got, want)  # dwx, dh0, dU_zr, dU_c


PLAIN_PHASES = dict(gates=v1.recompute_gates, recursion=v2.dh_bwd_plain,
                    tail=v1.wgrad_plain)


def _bwd_problem(seed, t, b, hw, units):
    rng = np.random.RandomState(seed)
    uzr, uc = _weights(rng, units)
    wx = _f32(rng, t, b, *hw, 3 * units)
    ys = _f32(rng, t, b, *hw, units, scale=0.5)
    h0 = _f32(rng, b, *hw, units, scale=0.5)
    g = _f32(rng, t, b, *hw, units)
    return uzr, uc, wx, ys, h0, g


@pytest.mark.parametrize("hw", [(7, 7), (5, 9)])
def test_convgru_bwd_phased_matches_jax_kernel_interpret(hw):
    """B4 as phase G, B2's recursion and phase W, each by its plain
    version, against the JAX kernel: the decomposition's algebra."""
    arrays = _bwd_problem(4, 3, 2, hw, 4)
    want = jv1._convgru_bwd_pallas(*map(jnp.asarray, arrays), interpret=True)
    got = v1.convgru_bwd_phased(*map(torch.from_numpy, arrays),
                                **PLAIN_PHASES)
    _assert_all_close(got, want)  # dwx, dh0, dU_zr, dU_c


@pytest.mark.parametrize("hw", [(7, 7), (5, 9)])
def test_convgru_bwd_phased_bf16_matches_the_step_by_step_plain(hw):
    """In bf16 rounding mode (wx in bf16) the phases round every conv and
    weight-gradient operand where the step-by-step plain version does;
    they differ by the f32 summation order of the weight gradients (one
    sum over all frames against T per-step sums)."""
    uzr, uc, wx, ys, h0, g = map(torch.from_numpy,
                                 _bwd_problem(5, 3, 2, hw, 4))
    wx = wx.to(torch.bfloat16)
    got = v1.convgru_bwd_phased(uzr, uc, wx, ys, h0, g, **PLAIN_PHASES)
    want = v1.convgru_bwd_plain(uzr, uc, wx, ys, h0, g)
    for i, (k, a) in enumerate(zip(got, want)):
        assert k.dtype == a.dtype == torch.float32
        np.testing.assert_allclose(k.numpy(), a.numpy(), err_msg=str(i),
                                   **TOL)


@pytest.mark.parametrize("hw", [(7, 7), (5, 9)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_b4_takes_exactly_what_b2_takes(hw, dtype):
    """B4 runs B2 unchanged, and phase G's shared memory is far below B2's,
    so B4's rule is B2's for every width."""
    for units in (16, 24, 32, 48, 64, 128, 256):
        assert (v1.kernel_takes(*hw, units, dtype)
                == v2.kernel_takes(*hw, units, dtype)), units


@pytest.mark.parametrize("elem", [2, 4])
def test_wgrad_slices_are_a_function_of_the_shapes(elem):
    """Phase W's split-K. bf16: 12 tiles of 64 channels (nine taps) by 64
    columns at U=128, 11 slices at T*B = 336 and 672 frames (132 CTAs: one
    wave at one per SM), never more slices than frames. f32: 27 tiles of
    128 x 128, 9 slices (243 CTAs, two per SM), never more slices than K
    chunks of 32."""
    tiles, slots, slices, few = {2: (12, 132, 11, 1), 4: (27, 264, 9, 2)}[elem]
    assert v1.wgrad_tiles(7, 7, 128, elem) == tiles
    assert (v1.wgrad_slices(336, 7, 7, 128, elem)
            == v1.wgrad_slices(672, 7, 7, 128, elem) == slices)
    assert v1.wgrad_slices(1, 7, 7, 16, elem) == few
    for units in (16, 32, 48, 64, 128, 256):
        for hw in ((7, 7), (5, 9)):
            n = v1.wgrad_tiles(*hw, units, elem)
            assert n * v1.wgrad_slices(1000, *hw, units, elem) <= slots


def test_conv_helpers_match_jax():
    rng = np.random.RandomState(2)
    g = _f32(rng, 2, 7, 7, 6)
    x = _f32(rng, 2, 7, 7, 5)
    kernel = _f32(rng, 3, 3, 5, 6)
    np.testing.assert_allclose(
        kconv.conv3x3_transpose(torch.from_numpy(g),
                             torch.from_numpy(kernel)).numpy(),
        np.asarray(jv1._conv3x3_transpose(jnp.asarray(g),
                                          jnp.asarray(kernel))), **TOL)
    want = jv1._conv3x3_kernel_grad(jnp.asarray(x), jnp.asarray(g))
    got = kconv.kernel_grad(torch.from_numpy(x), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the batched form over [T, B, ...] sums over both leading axes
    xs, gs = x.reshape(1, 2, 7, 7, 5), g.reshape(1, 2, 7, 7, 6)
    np.testing.assert_allclose(
        kconv.kernel_grad(torch.from_numpy(xs), torch.from_numpy(gs)).numpy(),
        np.asarray(jv2._kernel_grad(jnp.asarray(xs), jnp.asarray(gs))),
        **TOL)


def _scan_problem(seed):
    rng = np.random.RandomState(seed)
    t, b, cdim, units = 5, 2, 8, 4
    shapes = {k: v.shape for k, v in ConvGRU.init(cdim, units).items()}
    params = {k: _f32(rng, *s, scale=0.3) for k, s in shapes.items()}
    xs = _f32(rng, t, b, 7, 7, cdim)
    h0 = np.zeros((b, 7, 7, units), np.float32)
    target = _f32(rng, t, b, 7, 7, units)
    return params, xs, h0, target


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_trainable_scan_matches_jax_value_and_grad(version):
    """Each JAX entry point's namesake (both run `ConvGRUFused`) against
    `jax.value_and_grad` of the JAX `ConvGRU.scan`."""
    params, xs, h0, target = _scan_problem(seed=7)

    def j_loss(p):
        _, ys = JConvGRU.scan(p, jnp.asarray(xs), jnp.asarray(h0))
        return jnp.sum((ys - jnp.asarray(target)) ** 2)

    j_val, j_grads = jax.value_and_grad(j_loss)(
        {k: jnp.asarray(v) for k, v in params.items()})

    scan = {"v1": v1.convgru_scan_trainable,
            "v2": v1.convgru_scan_trainable_v2}[version]
    tparams = {k: torch.from_numpy(v).requires_grad_()
               for k, v in params.items()}
    before = (v1.launches, v2.launches)
    final, ys = scan(tparams, torch.from_numpy(xs), torch.from_numpy(h0),
                     compute_dtype=torch.float32)
    loss = ((ys - torch.from_numpy(target)) ** 2).sum()
    loss.backward()
    assert (v1.launches, v2.launches) == before  # CPU: plain versions
    assert torch.equal(final, ys[-1])
    np.testing.assert_allclose(loss.item(), float(j_val), rtol=1e-5)
    for k, p in tparams.items():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(j_grads[k]),
                                   err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_trainable_scan_bf16_tracks_plain_autograd(version):
    """In bf16 the Function rounds every conv operand to bf16 and sums in
    f32, where plain autograd of `ConvGRU.scan` also rounds each conv
    result to bf16: they agree to bf16 resolution (the parity gate)."""
    params, xs, h0, target = _scan_problem(seed=8)
    scan = {"v1": v1.convgru_scan_trainable,
            "v2": v1.convgru_scan_trainable_v2}[version]
    grads = []
    for fn in (ConvGRU.scan, scan):
        tparams = {k: torch.from_numpy(v).requires_grad_()
                   for k, v in params.items()}
        _, ys = fn(tparams, torch.from_numpy(xs), torch.from_numpy(h0),
                   compute_dtype=torch.bfloat16)
        ((ys - torch.from_numpy(target)) ** 2).sum().backward()
        grads.append({k: p.grad.float().numpy() for k, p in tparams.items()})
    for k in params:
        a, b = grads[0][k].ravel(), grads[1][k].ravel()
        assert np.corrcoef(a, b)[0, 1] >= 0.999, k
        assert np.abs(a - b).max() <= 0.05 * np.abs(a).max(), k


def test_v2_backward_runs_phases_g_and_w_and_matches_jax_v2(monkeypatch):
    """The Function's backward composes phase G (`bwd_gates`), B2 and phase
    W (`wgrad`), once each; on the CPU those are `recompute_gates`,
    `dh_bwd_plain` and `wgrad_plain`, so the loss and every gradient stay
    those of the JAX V2 (`convgru_scan_trainable_v2`, `_dh_bwd_pallas` in
    interpret mode)."""
    params, xs, h0, target = _scan_problem(seed=9)

    def j_loss(p):
        _, ys = jv2.convgru_scan_trainable_v2(
            p, jnp.asarray(xs), jnp.asarray(h0), compute_dtype=jnp.float32,
            interpret=True)
        return jnp.sum((ys - jnp.asarray(target)) ** 2)

    j_val, j_grads = jax.value_and_grad(j_loss)(
        {k: jnp.asarray(v) for k, v in params.items()})

    calls = []

    def recording(name, fn):
        def wrapped(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(v1, "bwd_gates", recording("G", v1.bwd_gates))
    monkeypatch.setattr(v1, "dh_bwd", recording("B2", v1.dh_bwd))
    monkeypatch.setattr(v1, "wgrad", recording("W", v1.wgrad))
    tparams = {k: torch.from_numpy(v).requires_grad_()
               for k, v in params.items()}
    _, ys = v1.convgru_scan_trainable_v2(
        tparams, torch.from_numpy(xs), torch.from_numpy(h0),
        compute_dtype=torch.float32)
    loss = ((ys - torch.from_numpy(target)) ** 2).sum()
    loss.backward()
    assert calls == ["G", "B2", "W"]
    np.testing.assert_allclose(loss.item(), float(j_val), rtol=1e-5)
    for k, p in tparams.items():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(j_grads[k]),
                                   err_msg=k, **GRAD_TOL)


def test_backward_wrappers_on_cpu_are_the_plain_versions():
    rng = np.random.RandomState(3)
    t, b, units = 2, 2, 4
    uzr, uc = (torch.from_numpy(w) for w in _weights(rng, units))
    wx = torch.from_numpy(_f32(rng, t, b, 7, 7, 3 * units))
    ys = torch.from_numpy(_f32(rng, t, b, 7, 7, units, scale=0.5))
    h0 = torch.from_numpy(_f32(rng, b, 7, 7, units, scale=0.5))
    g = torch.from_numpy(_f32(rng, t, b, 7, 7, units))
    before = (v1.launches, v2.launches)
    for got, want in zip(v1.convgru_bwd(uzr, uc, wx, ys, h0, g),
                         v1.convgru_bwd_plain(uzr, uc, wx, ys, h0, g)):
        assert torch.equal(got, want)
    for got, want in zip(v1.bwd_gates(uzr, uc, wx, h0, ys),
                         v1.recompute_gates(uzr, uc, wx, h0, ys)):
        assert torch.equal(got, want)
    dzr = torch.cat([g, -g], dim=-1)
    for got, want in zip(v1.wgrad(ys, dzr, h0.expand_as(ys), g),
                         v1.wgrad_plain(ys, dzr, h0.expand_as(ys), g)):
        assert torch.equal(got, want)
    streams = [torch.sigmoid(ys), torch.sigmoid(-ys), torch.tanh(ys),
               ys, g]
    for got, want in zip(v2.dh_bwd(*streams, uzr, uc),
                         v2.dh_bwd_plain(*streams, uzr, uc)):
        assert torch.equal(got, want)
    assert (v1.launches, v2.launches) == before
    assert (v1.gates_launches, v1.wgrad_launches) == (0, 0)


@pytest.mark.parametrize("kernel,outputs", [
    ("convgru_bwd", {"dzr", "da", "dh0"}),
    ("convgru_bwd_mono", {"dwx", "dh0", "dU_zr", "dU_c"}),
    ("convgru_bwd_gates", {"u", "r", "c", "hprev", "rh"}),
    ("convgru_wgrad", {"dU_zr", "dU_c"}),
])
def test_backward_parity_harness_runs_on_cpu(kernel, outputs):
    """On the CPU both sides of `backward_parity` are the plain version;
    this pins the harness itself (inputs from a real forward, stats, the
    gate)."""
    from recurrent_gaze_prediction_tpu_torch.ops.kernels.parity import (
        backward_parity, backward_parity_ok)

    stats = backward_parity(kernel, t=2, b=2, c=8, units=16, device="cpu")
    assert set(stats["outputs"]) == outputs
    assert all(o["max_delta"] == 0.0 for o in stats["outputs"].values())
    assert backward_parity_ok(stats)
    with pytest.raises(ValueError, match="unknown"):
        backward_parity("convlstm", t=1, b=1, c=8, units=16, device="cpu")
