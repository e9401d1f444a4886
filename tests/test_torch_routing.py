"""The models' recurrence route (fault C1): the kernels take U a positive
multiple of 16 whose CTA slice fits shared memory, decided from the shapes
before any launch; every other width runs the cell's own scan, as the JAX
package runs any width. On the CPU the route is taken as on the card (the
kernel route runs the wrappers' plain versions), and both routes give the
same maps."""

import numpy as np
import pytest
import torch

from recurrent_gaze_prediction_tpu_torch import registry
from recurrent_gaze_prediction_tpu_torch.models import streaming
from recurrent_gaze_prediction_tpu_torch.ops.kernels import convgru as kconv
from recurrent_gaze_prediction_tpu_torch.ops.kernels import convgru_vjp2 as v2
from recurrent_gaze_prediction_tpu_torch.ops.kernels import convlstm as klstm

# U -> whether B1, B2 and B3 take it on a 7x7 grid; the same in bf16 and
# f32 (U=256: a CTA's slice of the weights, bf16, or its two padded f32
# operands exceed the 227 KB of shared memory)
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
    kw = dict(device="cpu", dim_feature=16, dim_cnn_proj=8,
              rnn_state_size=units, compute_dtype=dtype)
    grcn = registry.create_model("gaze_grcn", **kw)
    lstm = registry.create_model("gaze_lstm", **kw)
    assert grcn.recurrence_route(train=False) == route
    assert grcn.recurrence_route(train=True) == route
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
