"""Kernel B5 (`ops/kernels/convgru_small.py`) on the CPU: its plain forward
and backward against `ConvGRU.scan` under autograd (remat on and off) at
the cascade's top-cell widths (64 -> U=3, 5x5, 49x49, B=2, T=3); the rule
that decides which cells it takes; its shared-memory reckoning; and the
cascade's routes and step tree with the top cell on it.

f32: the plain versions and the scan make the same convs in the same
precision, so they agree to f32 summation order (outputs bitwise here,
gradients within 1e-5 of each tensor's largest magnitude). bf16: they round
at different points (the scan rounds each conv's sum to bf16, and autograd
each step's weight gradient; B5's rule keeps both in f32), so the two agree
within 2e-2 of each tensor's largest magnitude (measured: at most 7e-3),
and B5's error against the f32 scan is at most 1.25x the bf16 scan's plus
1e-3 of that magnitude.
"""

import numpy as np
import pytest
import torch

from recurrent_gaze_prediction_tpu_torch import registry
from recurrent_gaze_prediction_tpu_torch.config import OptimizerConfig
from recurrent_gaze_prediction_tpu_torch.ops.cells import ConvGRU
from recurrent_gaze_prediction_tpu_torch.ops.kernels import convgru as kconv
from recurrent_gaze_prediction_tpu_torch.ops.kernels import convgru_grid as kg
from recurrent_gaze_prediction_tpu_torch.ops.kernels import convgru_small as ks
from recurrent_gaze_prediction_tpu_torch.ops.kernels import convgru_vjp2 as v2
from recurrent_gaze_prediction_tpu_torch.ops.kernels.route import (
    convgru_route)
from recurrent_gaze_prediction_tpu_torch.train import profiler
from recurrent_gaze_prediction_tpu_torch.train.state import (
    create_train_state, make_train_step)

T, B, C, UNITS, K, HW = 3, 2, 64, 3, 5, (49, 49)
NAMES = ["ys", "W_z", "U_z", "W_r", "U_r", "W", "U", "x", "h0"]


def _case(seed=0, units=UNITS, k=K, hw=HW, c=C, t=T, b=B):
    g = torch.Generator().manual_seed(seed)
    params = {n: (torch.randn(v.shape, generator=g) * 0.1).requires_grad_()
              for n, v in ConvGRU.init(c, units, kernel=(k, k)).items()}
    x = torch.randn(t, b, *hw, c, generator=g).requires_grad_()
    h0 = (0.3 * torch.randn(b, *hw, units, generator=g)).requires_grad_()
    cot = torch.randn(t, b, *hw, units, generator=g)
    return params, x, h0, cot


def _outputs(scan, case, cdt, **kw):
    """ys and the gradients of sum(ys * cot) wrt every param, x and h0."""
    params, x, h0, cot = case
    _, ys = scan(params, x, h0, compute_dtype=cdt, **kw)
    grads = torch.autograd.grad((ys * cot).sum(), [*params.values(), x, h0])
    return [ys.detach(), *grads]


def _rel(a, b, scale):
    return float((a.float() - b.float()).abs().max()) / scale


@pytest.mark.parametrize("remat", [False, True])
def test_plain_versions_match_the_scan_in_f32(remat):
    case = _case()
    want = _outputs(ConvGRU.scan, case, torch.float32, remat=remat)
    got = _outputs(ks.convgru_scan_small, case, torch.float32)
    assert torch.equal(got[0], want[0])
    for name, g, w in zip(NAMES, got, want):
        assert _rel(g, w, float(w.abs().max())) <= 1e-5, name


@pytest.mark.parametrize("remat", [False, True])
def test_plain_versions_match_the_scan_in_bf16(remat):
    case = _case(seed=1)
    f32 = _outputs(ConvGRU.scan, case, torch.float32)
    scan = _outputs(ConvGRU.scan, case, torch.bfloat16, remat=remat)
    small = _outputs(ks.convgru_scan_small, case, torch.bfloat16)
    for name, s, k, r in zip(NAMES, scan, small, f32):
        scale = float(r.abs().max())
        assert _rel(k, s, scale) <= 2e-2, name
        assert _rel(k, r, scale) <= 1.25 * _rel(s, r, scale) + 1e-3, name


@pytest.mark.parametrize("units,k,hw", [(1, 3, (7, 9)), (2, 5, (6, 5)),
                                        (4, 3, (11, 4))])
def test_plain_backward_is_the_recursion_autograd_takes(units, k, hw):
    """`backward_plain` against autograd through `forward_plain` in f32,
    at other widths, kernels and grids than the cascade's."""
    params, x, h0, cot = _case(seed=2, units=units, k=k, hw=hw, c=5, t=4)
    fused = ConvGRU.fuse(params)
    wx = ConvGRU.input_gates(fused, x.detach()).requires_grad_()
    uzr = fused["Uh_zr"].detach().requires_grad_()
    uc = fused["U_c"].detach().requires_grad_()
    h = h0.detach().requires_grad_()
    ys = ks.forward_plain(uzr, uc, wx, h)
    want = torch.autograd.grad((ys * cot).sum(), [wx, h, uzr, uc])
    got = ks.backward_plain(uzr.detach(), uc.detach(), wx.detach(),
                            h.detach(), ys.detach(), cot)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4,
                                   atol=1e-5 * float(w.abs().max()))


def test_kernel_takes_the_top_cell_only():
    bf16 = torch.bfloat16
    assert ks.kernel_takes(49, 49, 3, bf16, (5, 5))
    assert not ks.kernel_takes(49, 49, 3, torch.float32, (5, 5))
    # the cascade's bottom cell, and every shape B1 takes
    assert not ks.kernel_takes(7, 7, 256, bf16, (3, 3))
    for units in (16, 32, 48, 64, 128):
        assert kconv.kernel_takes(7, 7, units, bf16)
        assert not ks.kernel_takes(7, 7, units, bf16, (3, 3))
    # only the shape that is built: 5x5, U=3, small ragged grids too
    for hw in ((2, 3), (13, 6), (7, 7)):
        assert ks.kernel_takes(*hw, 3, bf16, (5, 5))
    for units in (1, 2, 4):
        assert not ks.kernel_takes(49, 49, units, bf16, (5, 5))
    for kernel in ((1, 1), (3, 3), (7, 7), (5, 3), (4, 4)):
        assert not ks.kernel_takes(49, 49, 3, bf16, kernel)
    # one group of five pixels a thread: 2,560 pixels at most
    assert ks.MAX_PIXELS == 2560
    assert ks.kernel_takes(40, 64, 3, bf16, (5, 5))
    assert ks.kernel_takes(50, 51, 3, bf16, (5, 5))
    for hw in ((51, 51), (60, 60), (41, 64), (64, 64)):
        assert not ks.kernel_takes(*hw, 3, bf16, (5, 5))
    # and the backward's shared memory: a long thin grid's padding
    assert not ks.kernel_takes(1, 2560, 3, bf16, (5, 5))


def test_smem_reckoning():
    """The CTA's shared memory as `csrc/convgru_small.cu` lays it out, at
    the top cell: forward weights 3,712 + two padded 53x53 operands 22,528
    each + f32 h and u 28,928 each; backward three padded 4-slot operands,
    one 8-slot 45,056, and f32 u, r and dh."""
    assert ks.smem_bytes(49, 49, 5, 3, False) == 106624
    assert ks.smem_bytes(49, 49, 5, 3, True) == 203136
    assert ks.smem_bytes(49, 49, 5, 3, True) <= kconv.SMEM_LIMIT
    # a 2x2 grid padded to 6x6: 384 B a 4-slot operand, 640 the 8-slot one,
    # 128 each f32 array
    assert ks.smem_bytes(2, 2, 5, 3, True) == 3712 + 3 * 384 + 640 + 3 * 128


def test_wrappers_refuse_what_the_kernel_does_not_take():
    params, x, h0, _ = _case(t=1, b=1)
    fused = ConvGRU.fuse({n: p.detach() for n, p in params.items()})
    wx = ConvGRU.input_gates(fused, x.detach(), torch.float32)
    with pytest.raises(ValueError, match="convgru_small takes"):
        ks._check(fused["Uh_zr"], fused["U_c"], wx, h0.detach())
    with pytest.raises(ValueError, match="no small ConvGRU kernel"):
        ks.recurrence(fused["Uh_zr"], fused["U_c"], wx.to("meta"),
                      h0.detach())


def _cascade(dtype):
    return registry.create_model("gaze_grcn_cascade", device="cpu",
                                 compute_dtype=dtype, loss_type="l2",
                                 n_lstm_steps=T,
                                 generator=torch.Generator().manual_seed(0))


def _cascade_batch():
    rng = np.random.RandomState(2)
    return {"c3d": torch.from_numpy(rng.rand(B, T, 1024, 7, 7)).float(),
            "gazemaps": torch.from_numpy(rng.rand(B, T, 49, 49)).float()}


@pytest.mark.parametrize("dtype,top", [("bfloat16", "kernel"),
                                       ("float32", "scan")])
def test_cascade_routes(dtype, top):
    """`last_route` keeps its meaning (the bottom cell's route: B6 in bf16,
    the plain scan in f32); the top cell's own route is B5 in bf16, the
    plain scan in f32."""
    model = _cascade(dtype)
    assert convgru_route(model.top_cell, (49, 49), getattr(torch, dtype),
                         True) == top
    assert model.recurrence_route(train=True) == top
    with torch.no_grad():
        model(None, _cascade_batch()["c3d"])
    assert model.last_route == top and model.top_route == top


def test_cascade_bf16_step_tree_counts_both_plain_loops():
    """A bf16 train step on the CPU: the bottom cell on B6's plain
    versions, the top cell on B5's (each one launch's worth of work, no
    kernel), still 3 + 3 plain steps, counted on each cell's span; no
    B1/B2/B5/B6 launch."""
    model = _cascade("bfloat16")
    state, tx = create_train_state(model, OptimizerConfig())
    step = make_train_step(model, tx)
    before = (ks.launches, kg.launches, kconv.launches, v2.launches)
    profiler.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        step(state, _cascade_batch(), torch.Generator().manual_seed(0))
    counted = {r["name"]: r["counts"] for r in profiler.records()
               if r["counts"]}
    profiler.clear()
    assert model.top_route == "kernel" and model.last_route == "kernel"
    assert counted == {"gaze.recurrence": {"recurrence.plain_steps": T},
                       "gaze.top_recurrence": {"recurrence.plain_steps": T}}
    assert (ks.launches, kg.launches, kconv.launches, v2.launches) == before
