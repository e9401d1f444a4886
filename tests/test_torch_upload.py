"""The served video's upload (`serving/upload.py`) on the CPU: the lane
pool's checkout and growth, a lane's buffer, the chunk plan, and the direct
path that a CPU model or a video already on its device takes, with its
`upload.staged_bytes` of 0 under a recording profiler. The lane path
itself runs on the card (`tests/test_torch_cuda.py`)."""

import sys
import threading

import numpy as np
import pytest
import torch

from recurrent_gaze_prediction_tpu_torch import registry
from recurrent_gaze_prediction_tpu_torch.models import c3d, quant
from recurrent_gaze_prediction_tpu_torch.serving import upload
from recurrent_gaze_prediction_tpu_torch.serving.bundle import (
    fused_int8_predict_fn, fused_predict_fn, load_bundle, save_bundle)
from recurrent_gaze_prediction_tpu_torch.train import profiler

CPU = torch.device("cpu")
TINY_TOWER = (8, 8, 16, 16, 16, 16, 16, 512)


def test_pool_returns_a_lane_and_hands_it_out_again():
    pool = upload.LanePool(CPU)
    with pool.checkout() as first:
        pass
    with pool.checkout() as second:
        assert second is first
    with pool.checkout() as outer, pool.checkout() as inner:
        assert inner is not outer
    assert len(pool.lanes) == 2


@pytest.mark.parametrize("callers", [1, 3, 8])
def test_pool_grows_to_the_concurrent_callers_only(callers):
    """`callers` threads that hold a lane at once make that many lanes; as
    many rounds again, one caller at a time, make none."""
    pool = upload.LanePool(CPU)
    held = threading.Barrier(callers, timeout=30)
    seen = []

    def call():
        with pool.checkout() as lane:
            seen.append(lane)
            held.wait()

    threads = [threading.Thread(target=call) for _ in range(callers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len({id(lane) for lane in seen}) == callers == len(pool.lanes)
    for _ in range(2 * callers):
        with pool.checkout():
            pass
    assert len(pool.lanes) == callers


def test_pool_never_hands_one_lane_to_two_callers():
    """32 threads check lanes out and in 200 times each under a short
    switch interval: no lane is ever held twice at once, and the pool makes
    no more lanes than there are threads."""
    pool = upload.LanePool(CPU)
    held, clashes, lock = set(), [], threading.Lock()

    def call():
        for _ in range(200):
            with pool.checkout() as lane:
                with lock:
                    if id(lane) in held:
                        clashes.append(id(lane))
                    held.add(id(lane))
                with lock:
                    held.discard(id(lane))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=call) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert clashes == [] and 1 <= len(pool.lanes) <= 32


def test_lane_buffer_regrows_for_a_larger_request_only():
    lane = upload.Lane(CPU)
    small = lane.staging(100)
    first = lane.buffer
    assert small.numel() == 100 and first.numel() == 100
    larger = lane.staging(1000)
    assert larger.numel() == 1000 and lane.buffer.numel() == 1000
    grown = lane.buffer
    again = lane.staging(10)
    assert again.numel() == 10 and lane.buffer is grown
    assert again.data_ptr() == grown.data_ptr()


@pytest.mark.parametrize("nbytes,rows,chunks", [
    (16 * 160 * 128 * 171 * 3, 16, 16), (60, 3, 3), (7, 1, 1), (0, 4, 0),
    (5, 5, 5)])
def test_chunk_plan_covers_the_bytes_once_in_order(nbytes, rows, chunks):
    """Consecutive non-empty ranges from 0 to the request's end, one a
    row."""
    plan = upload.chunk_plan(nbytes, rows)
    assert len(plan) == chunks
    assert all(stop > start for start, stop in plan)
    edges = [0] + [stop for _, stop in plan]
    assert [start for start, _ in plan] == edges[:-1]
    assert edges[-1] == nbytes


@pytest.mark.parametrize("as_tensor", [False, True])
def test_a_cpu_device_or_resident_input_goes_directly(as_tensor):
    """On a CPU device nothing is staged and no lane is made, for a numpy
    array and for a tensor already there (returned as it is)."""
    pool = upload.LanePool(CPU)
    video = np.arange(2 * 3 * 4, dtype=np.uint8).reshape(2, 3, 4)
    given = torch.from_numpy(video) if as_tensor else video
    out, staged = upload.stage_to_device(given, CPU, pool)
    assert staged == 0 and not pool.lanes
    assert out.dtype == torch.uint8 and torch.equal(
        out, torch.from_numpy(video))
    if as_tensor:
        assert out is given


def _tiny_tower():
    g = torch.Generator().manual_seed(3)
    params, cin = {}, 3
    for (name, _), cout in zip(c3d.CONV_LAYERS, TINY_TOWER):
        params[f"{name}_w"] = torch.randn((cout, cin, 3, 3, 3), generator=g) \
            / (27 * cin) ** 0.5
        params[f"{name}_b"] = torch.zeros(cout)
        cin = cout
    return params


@pytest.mark.parametrize("program", ["fused", "fused_int8"])
def test_cpu_model_counts_no_staged_bytes(tmp_path, program):
    """Both served programs on a CPU model: the upload is direct, and each
    recorded `serve.predict` counts `upload.staged_bytes` 0."""
    model = registry.create_model(
        "gaze_grcn", device="cpu", dim_cnn_proj=8, rnn_state_size=8,
        compute_dtype="float32", n_lstm_steps=2, batch_size=2)
    tower = _tiny_tower()
    kwargs = ({"c3d_params": tower, "c3d_compute_dtype": "float32"}
              if program == "fused" else
              {"int8_qparams": quant.quantize_for_pipeline(tower)})
    save_bundle(str(tmp_path), model, num_frames=16, video_hw=(64, 80),
                video_dtype="uint8", **kwargs)
    served = load_bundle(str(tmp_path), device="cpu")
    predict = (fused_predict_fn if program == "fused"
               else fused_int8_predict_fn)(served)
    video = np.random.RandomState(5).randint(
        0, 256, (1, 16, 64, 80, 3)).astype(np.uint8)
    profiler.clear()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            predict(video)
            predict(torch.from_numpy(video))
        roots = [r for r in profiler.records()
                 if r["name"] == "serve.predict"]
        assert len(roots) == 2
        assert all(r["counts"] == {"upload.staged_bytes": 0} for r in roots)
        assert profiler.counts()["upload.staged_bytes"] == 0
    finally:
        profiler.clear()
