"""The models' recurrence route (fault C1): the cluster kernels take U a
positive multiple of 16 whose CTA slice fits shared memory, B6 a bf16
3x3 ConvGRU too wide for them (U=256 at 7x7), decided from the shapes
before any launch; every other width runs the cell's own scan, as the JAX
package runs any width. Every shape B1 or B5 takes keeps its kernel. On
the CPU the route is taken as on the card (the kernel route runs the
wrappers' plain versions), and both routes give the same maps."""

import numpy as np
import pytest
import torch

from recurrent_gaze_prediction_tpu_torch import registry
from recurrent_gaze_prediction_tpu_torch.models import streaming
from recurrent_gaze_prediction_tpu_torch.ops.cells import ConvGRU
from recurrent_gaze_prediction_tpu_torch.ops.kernels import convgru as kconv
from recurrent_gaze_prediction_tpu_torch.ops.kernels import convgru_grid as kg
from recurrent_gaze_prediction_tpu_torch.ops.kernels import convgru_small as ks
from recurrent_gaze_prediction_tpu_torch.ops.kernels import convgru_vjp as v1
from recurrent_gaze_prediction_tpu_torch.ops.kernels import convgru_vjp2 as v2
from recurrent_gaze_prediction_tpu_torch.ops.kernels import convlstm as klstm
from recurrent_gaze_prediction_tpu_torch.ops.kernels import route
from recurrent_gaze_prediction_tpu_torch.ops.kernels.route import (
    convgru_route)

# U -> whether B1, B2 and B3 take it on a 7x7 grid; the same in bf16 and
# f32 (U=256: a CTA's slice of the weights, bf16, or its two padded f32
# operands exceed the 227 KB of shared memory; in bf16 gaze_grcn's cell
# then takes B6)
TAKES = {16: True, 24: False, 64: True, 128: True, 256: False}


@pytest.mark.parametrize("units", sorted(TAKES))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_route_rule(units, dtype):
    tdt = getattr(torch, dtype)
    want = TAKES[units]
    assert kconv.kernel_takes(7, 7, units, tdt) is want
    assert v2.kernel_takes(7, 7, units, tdt) is want
    assert klstm.kernel_takes(7, 7, units, tdt) is want
    route = "kernel" if want else "scan"
    b6 = units == 256 and dtype == "bfloat16"
    assert kg.kernel_takes(7, 7, units, tdt) is b6
    kw = dict(device="cpu", dim_feature=16, dim_cnn_proj=8,
              rnn_state_size=units, compute_dtype=dtype)
    grcn = registry.create_model("gaze_grcn", **kw)
    lstm = registry.create_model("gaze_lstm", **kw)
    grcn_route = "kernel" if want or b6 else "scan"
    assert grcn.recurrence_route(train=False) == grcn_route
    assert grcn.recurrence_route(train=True) == grcn_route
    assert lstm.recurrence_route(train=False) == route
    assert lstm.recurrence_route(train=True) == "scan"  # no backward kernel


def test_rule_agrees_with_what_the_wrappers_raise_on():
    for units in (8, 24, 256):
        for dtype in (torch.bfloat16, torch.float32):
            assert not kconv.kernel_takes(7, 7, units, dtype)
    assert not kconv.kernel_takes(7, 7, 128, torch.float16)
    # the shared-memory reckoning the wrappers check before a launch
    assert kconv.smem_bytes(7, 7, 256, 2) > kconv.SMEM_LIMIT
    assert kconv.smem_bytes(7, 7, 128, 2) <= kconv.SMEM_LIMIT


@pytest.mark.parametrize("name", ["gaze_grcn", "gaze_lstm"])
@pytest.mark.parametrize("units", [24, 32])
def test_both_routes_predict_and_stream_the_same_maps(name, units):
    model = registry.create_model(
        name, device="cpu", dim_feature=16, dim_cnn_proj=8,
        rnn_state_size=units, n_lstm_steps=3, compute_dtype="float32")
    with torch.no_grad():
        for p in model.cell.values():
            p.copy_(torch.randn(p.shape, generator=torch.Generator()
                                .manual_seed(1)) * 0.1)
    c3d = torch.from_numpy(np.random.RandomState(0).randn(
        2, 3, 16, 7, 7).astype(np.float32))
    maps = model.predict(None, c3d)
    assert model.last_route == ("scan" if units == 24 else "kernel")
    # the other route on the same weights: the plain scan is what the
    # kernel wrappers run on the CPU
    model.recurrence_route = lambda train: "scan"
    np.testing.assert_allclose(model.predict(None, c3d).numpy(),
                               maps.numpy(), rtol=1e-5, atol=1e-9)
    del model.recurrence_route
    if name == "gaze_grcn":
        state = streaming.init_stream_state(2, model.cfg, device="cpu")
        _, logits = streaming.grcn_stream_step(model, state, c3d)
    else:
        state = streaming.init_lstm_stream_state(2, model.cfg, device="cpu")
        _, logits = streaming.lstm_stream_step(model, state, c3d)
    assert logits.shape == (2, 3, 49, 49)
    np.testing.assert_allclose(torch.softmax(logits.reshape(2, 3, -1), -1)
                               .reshape(maps.shape).numpy(), maps.numpy(),
                               rtol=1e-4, atol=1e-8)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_route_checks_the_kernel_size(dtype):
    """B1 and B2 are 3x3 kernels: a 5x5 cell is routed to the scan even at
    a width they take (U=16), on any grid; the cascade's bottom cell (U=256
    3x3 at 7x7) takes kernel B6 in bf16 and the scan in f32, its top cell
    (U=3 5x5 at 49x49) kernel B5 in bf16 and the scan in f32;
    gaze_pupil_grcn's U=64 cell takes the kernels, to predict and to
    train."""
    tdt = getattr(torch, dtype)
    for kernel, want in (((3, 3), True), ((5, 5), False), ((3, 5), False)):
        assert kconv.kernel_takes(7, 7, 16, tdt, kernel) is want
        assert v2.kernel_takes(7, 7, 16, tdt, kernel) is want
        cell = ConvGRU.init(8, 16, kernel=kernel)
        for train in (False, True):
            assert convgru_route(cell, (7, 7), tdt, train) == (
                "kernel" if want else "scan")
    cascade = registry.create_model("gaze_grcn_cascade", device="cpu",
                                    compute_dtype=dtype)
    on_kernels = "kernel" if dtype == "bfloat16" else "scan"
    for train in (False, True):
        assert convgru_route(cascade.bottom_cell, (7, 7), tdt,
                             train) == on_kernels
        assert convgru_route(cascade.top_cell, (49, 49), tdt,
                             train) == on_kernels
    assert cascade.recurrence_route(train=True) == on_kernels
    pupil = registry.create_model("gaze_pupil_grcn", device="cpu",
                                  compute_dtype=dtype)
    assert pupil.cfg.rnn_state_size == 64 and kconv.cluster_size(64) == 4
    assert pupil.recurrence_route(train=False) == "kernel"
    assert pupil.recurrence_route(train=True) == "kernel"


def test_pupil_grcn_predicts_and_trains_on_its_route():
    """gaze_pupil_grcn records its route; on the CPU the kernel route runs
    the wrappers' plain versions and gives the scan's maps."""
    model = registry.create_model("gaze_pupil_grcn", device="cpu",
                                  n_lstm_steps=3, compute_dtype="float32")
    with torch.no_grad():
        for p in model.cell.values():
            p.copy_(torch.randn(p.shape, generator=torch.Generator()
                                .manual_seed(1)) * 0.05)
    c3d = torch.from_numpy(np.random.RandomState(0).randn(
        2, 3, 1024, 7, 7).astype(np.float32))
    maps = model.predict(None, c3d)
    assert model.last_route == "kernel" and maps.shape == (2, 3, 7, 7)
    model.recurrence_route = lambda train: "scan"
    np.testing.assert_allclose(model.predict(None, c3d).numpy(),
                               maps.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_every_b1_and_b5_route_is_unchanged(dtype):
    """Over grids up to 9x9 (and the cascade's 49x49), widths 3..512 and
    3x3 / 5x5 kernels, to predict and to train: a cell B1 takes (and to
    train G, B2 and W) runs B1's scan or the trainable Function, one B5
    takes B5's, and B6 takes only cells neither takes (a cell B1 takes to
    predict but G, B2 or W refuse to train keeps the plain scan to
    train)."""
    grids = [(h, w) for h in range(1, 10) for w in range(1, 10)] + [(49, 49)]
    for hw in grids:
        for units in (3, 16, 24, 64, 128, 256, 384, 512):
            for kernel in ((3, 3), (5, 5)):
                cell = {"U": torch.empty(*kernel, units, units)}
                b1 = kconv.kernel_takes(*hw, units, dtype, kernel)
                b5 = ks.kernel_takes(*hw, units, dtype, kernel)
                b6 = kg.kernel_takes(*hw, units, dtype, kernel)
                assert b1 + b5 + b6 <= 1
                for train in (False, True):
                    scan = route._kernel_scan(cell, hw, dtype, train)
                    if b1:
                        want = (kconv.convgru_scan if not train
                                else v1.convgru_scan_trainable
                                if v1.kernel_takes(*hw, units, dtype, kernel)
                                else None)
                    else:
                        want = (ks.convgru_scan_small if b5
                                else kg.convgru_scan_grid if b6 else None)
                    assert scan is want, (hw, units, kernel, train)
                    assert convgru_route(cell, hw, dtype, train) == (
                        "scan" if want is None else "kernel")


def test_run_convgru_refuses_a_kernel_route_no_kernel_takes():
    """The kernel route for a cell no kernel takes (U=24) raises instead of
    running something else."""
    cell = ConvGRU.init(8, 24)
    xs = torch.zeros(2, 1, 7, 7, 8)
    with pytest.raises(ValueError, match="no kernel takes"):
        route.run_convgru(cell, xs, torch.zeros(1, 7, 7, 24),
                          compute_dtype=torch.bfloat16, train=False,
                          route="kernel")
