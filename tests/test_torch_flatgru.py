"""FlatGRU and the ConvGRU's kernel size and remat, against the JAX
package's `ops/cells.py` on the CPU in f32: FlatGRU (TF `GRUCell`: [r, u]
gate order, gate bias 1.0, orthogonal kernels, input side hoisted out of
the scan) step and scan, the ConvGRU with a 5x5 kernel at 49x49 (the
cascade's top cell), and the per-step remat of `ConvGRU.scan`.

Forward at rtol 1e-4 / atol 1e-5, gradients at rtol 1e-3 / atol 1e-5. The
5x5 cell's gradients sum 2*49*49 positions per weight, reach ~20 here,
and are held at atol 1e-5 times their largest magnitude (measured: one
element of 4800, of value 8.5e-3, off by 2.5e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recurrent_gaze_prediction_tpu.ops.cells import ConvGRU as JConvGRU
from recurrent_gaze_prediction_tpu.ops.cells import FlatGRU as JFlatGRU
from recurrent_gaze_prediction_tpu_torch.ops import initializers as ti
from recurrent_gaze_prediction_tpu_torch.ops.cells import ConvGRU, FlatGRU
from test_torch_zoo import torch_threads_per_worker  # noqa: F401

F32 = dict(rtol=1e-4, atol=1e-5)


def _flat_params(d, units, seed=0):
    rng = np.random.RandomState(seed)
    return {"gates_kernel": (rng.randn(d + units, 2 * units)
                             / np.sqrt(d + units)).astype(np.float32),
            "gates_bias": (1 + 0.1 * rng.randn(2 * units)).astype(np.float32),
            "candidate_kernel": (rng.randn(d + units, units)
                                 / np.sqrt(d + units)).astype(np.float32),
            "candidate_bias": (0.1 * rng.randn(units)).astype(np.float32)}


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def test_flat_gru_init_follows_tf():
    """Orthogonal kernels of the JAX package's shapes, gate bias 1.0,
    candidate bias 0 (gaze_rnn's full widths are held in
    test_torch_bridge.py)."""
    p = FlatGRU.init(48, 40, generator=torch.Generator().manual_seed(0))
    jp = JFlatGRU.init(jax.random.PRNGKey(0), 48, 40)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: v.shape for k, v in jp.items()}
    assert torch.equal(p["gates_bias"], torch.ones(2 * 40))
    assert torch.equal(p["candidate_bias"], torch.zeros(40))


@pytest.mark.parametrize("shape", [(88, 80), (88, 40), (50, 128),
                                   (64, 64)])
def test_orthogonal_init(shape):
    """Q^T Q = I over the shorter side, for tall, wide and square shapes;
    the same generator seed gives the same tensor."""
    draw = lambda: ti.orthogonal(shape,  # noqa: E731
                                 generator=torch.Generator().manual_seed(3))
    q = draw()
    assert tuple(q.shape) == shape
    gram = q.T @ q if shape[0] >= shape[1] else q @ q.T
    np.testing.assert_allclose(gram.numpy(), np.eye(min(shape)), atol=1e-4)
    assert torch.equal(q, draw())
    assert torch.equal(ti.constant(1.0, (3, 2)), torch.ones(3, 2))


def test_flat_gru_step_matches_jax():
    d, units, b = 24, 16, 3
    params = _flat_params(d, units)
    rng = np.random.RandomState(1)
    x = rng.randn(b, d).astype(np.float32)
    h = rng.randn(b, units).astype(np.float32) * 0.5
    j_h, _ = JFlatGRU.step(_j(params), jnp.asarray(h), jnp.asarray(x))
    t_h, _ = FlatGRU.step(_t(params), torch.from_numpy(h),
                          torch.from_numpy(x))
    np.testing.assert_allclose(t_h.numpy(), np.asarray(j_h), **F32)


@pytest.mark.parametrize("d,units", [(24, 16), (1568, 1617)])
def test_flat_gru_scan_and_grads_match_jax(d, units):
    """The hoisted scan (gaze_rnn's widths too: 7*7*32 -> 1617) and its
    gradients with respect to the params, the inputs and h0."""
    t, b = 4, 2
    params = _flat_params(d, units, seed=2)
    rng = np.random.RandomState(3)
    xs = rng.randn(t, b, d).astype(np.float32)
    h0 = (0.3 * rng.randn(b, units)).astype(np.float32)
    g = rng.randn(t, b, units).astype(np.float32)

    def j_obj(p, x, h):
        hT, ys = JFlatGRU.scan(p, x, h)
        return jnp.sum(ys * g) + jnp.sum(hT)

    j_val, j_grads = jax.value_and_grad(j_obj, argnums=(0, 1, 2))(
        _j(params), jnp.asarray(xs), jnp.asarray(h0))
    tp = {k: v.requires_grad_() for k, v in _t(params).items()}
    tx = torch.from_numpy(xs).requires_grad_()
    th = torch.from_numpy(h0).requires_grad_()
    hT, ys = FlatGRU.scan(tp, tx, th)
    val = (ys * torch.from_numpy(g)).sum() + hT.sum()
    grads = torch.autograd.grad(val, [*tp.values(), tx, th])
    np.testing.assert_allclose(float(val.detach()), float(j_val), rtol=1e-4)
    want = [j_grads[0][k] for k in tp] + [j_grads[1], j_grads[2]]
    for got, w in zip(grads, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=1e-5)


def _conv_params(kernel, c, units, seed):
    shapes = ConvGRU.init(c, units, kernel=kernel)
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*v.shape) / np.sqrt(np.prod(v.shape[:3])))
            .astype(np.float32) for k, v in shapes.items()}


def test_convgru_init_takes_the_kernel_size():
    p = ConvGRU.init(64, 3, kernel=(5, 5))
    jp = JConvGRU.init(jax.random.PRNGKey(0), 64, 3, kernel=(5, 5))
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: v.shape for k, v in jp.items()}
    assert ConvGRU.kernel_size(p) == (5, 5)
    assert ConvGRU.kernel_size(ConvGRU.init(8, 16)) == (3, 3)


def test_convgru_5x5_at_49x49_matches_jax():
    """The cascade's top cell: 64 -> 3 units, 5x5 SAME state convs on the
    49x49 grid; outputs and gradients of the params, inputs and h0."""
    t, b, c, units = 3, 2, 64, 3
    params = _conv_params((5, 5), c, units, seed=4)
    rng = np.random.RandomState(5)
    xs = rng.randn(t, b, 49, 49, c).astype(np.float32)
    h0 = (0.3 * rng.randn(b, 49, 49, units)).astype(np.float32)
    g = rng.randn(t, b, 49, 49, units).astype(np.float32)

    def j_obj(p, x, h):
        _, ys = JConvGRU.scan(p, x, h)
        return jnp.sum(ys * g)

    j_val, j_grads = jax.value_and_grad(j_obj, argnums=(0, 1, 2))(
        _j(params), jnp.asarray(xs), jnp.asarray(h0))
    tp = {k: v.requires_grad_() for k, v in _t(params).items()}
    tx = torch.from_numpy(xs).requires_grad_()
    th = torch.from_numpy(h0).requires_grad_()
    hT, ys = ConvGRU.scan(tp, tx, th, compute_dtype=torch.float32)
    assert torch.equal(hT, ys[-1])
    _, j_ys = JConvGRU.scan(_j(params), jnp.asarray(xs), jnp.asarray(h0))
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(j_ys), **F32)
    val = (ys * torch.from_numpy(g)).sum()
    grads = torch.autograd.grad(val, [*tp.values(), tx, th])
    np.testing.assert_allclose(float(val.detach()), float(j_val), rtol=1e-4)
    want = [j_grads[0][k] for k in tp] + [j_grads[1], j_grads[2]]
    for got, w in zip(grads, want):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-3,
                                   atol=1e-5 * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("kernel,hw,units", [((3, 3), (7, 7), 16),
                                             ((5, 5), (49, 49), 3)])
def test_convgru_remat_changes_no_number(kernel, hw, units):
    """`scan(remat=True)` checkpoints each step: the same outputs and the
    same gradients as without, and under no_grad it just runs."""
    t, b, c = 4, 2, 8
    params = _conv_params(kernel, c, units, seed=6)
    rng = np.random.RandomState(7)
    xs = torch.from_numpy(rng.randn(t, b, *hw, c).astype(np.float32))
    h0 = torch.from_numpy((0.3 * rng.randn(b, *hw, units)).astype(
        np.float32))
    out = {}
    for remat in (False, True):
        tp = {k: v.clone().requires_grad_() for k, v in _t(params).items()}
        _, ys = ConvGRU.scan(tp, xs, h0, compute_dtype=torch.float32,
                             remat=remat)
        grads = torch.autograd.grad(ys.square().sum(), list(tp.values()))
        out[remat] = (ys.detach(), grads)
    assert torch.equal(out[True][0], out[False][0])
    for a, b_ in zip(out[True][1], out[False][1]):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=1e-6,
                                   atol=1e-9)
    with torch.no_grad():
        _, ys = ConvGRU.scan(_t(params), xs, h0, compute_dtype=torch.float32,
                             remat=True)
    assert torch.equal(ys, out[False][0])
