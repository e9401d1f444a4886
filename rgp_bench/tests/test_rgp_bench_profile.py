"""The trace's reduction on a synthetic trace: busy time as the union of
device intervals, idle = window - busy, copies by direction, idle gaps
labelled by the innermost host event over them."""

import pytest

from rgp_bench import profile


def ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid}


EVENTS = [
    ev("user_annotation", "request", 0, 100),
    ev("cpu_op", "aten::to", 0, 30),
    ev("cuda_runtime", "cudaMemcpyAsync", 5, 20),
    ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 10, 10, tid=7),
    ev("kernel", "conv3d_int8_wgmma<256>", 30, 20, tid=7),
    ev("kernel", "conv3d_int8_halo", 40, 20, tid=7),   # overlaps the last
    ev("kernel", "maxpool3d_int8_kernel", 70, 10, tid=7),
    ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 90, 5, tid=7),
    {"ph": "i", "name": "instant", "ts": 3},         # no duration: ignored
]


def test_union_busy_and_idle():
    s = profile.summarize(EVENTS)
    assert s["window_s"] == pytest.approx(100e-6)
    # copies 10 + 5, kernels [30, 60) and [70, 80)
    assert s["kernel_busy_s"] == pytest.approx(40e-6)
    assert s["busy_s"] == pytest.approx(55e-6)
    assert s["copy_s"] == {"HtoD": pytest.approx(10e-6),
                           "DtoH": pytest.approx(5e-6)}
    assert profile.kernel_seconds(s, ("conv3d_int8", "maxpool3d_int8")) \
        == pytest.approx(50e-6)


def test_idle_gaps_by_innermost_host_event():
    s = profile.summarize(EVENTS)
    gaps = dict(s["breakdown"]["idle_gaps"])
    # the gap [0,10) has its midpoint under the memcpy call [5,25), the
    # gap [20,30) its midpoint 25 under aten::to alone (intervals are
    # [start, end))
    assert gaps["cudaMemcpyAsync"] == pytest.approx(10e-6)
    assert gaps["aten::to"] == pytest.approx(10e-6)
    # [60,70), [80,90), [95,100) under the request's annotation alone
    assert gaps["request"] == pytest.approx(25e-6)
    total = sum(gaps.values())
    assert total == pytest.approx(s["window_s"] - s["busy_s"])
    names = [n for n, _ in s["breakdown"]["device_ops"]]
    assert names[0] in ("conv3d_int8_wgmma<256>", "conv3d_int8_halo")
    assert len(s["breakdown"]["device_ops"]) <= profile.TOP


def test_union_of_disjoint_and_nested_intervals():
    import numpy as np

    rows = np.array([[5.0, 6.0], [0.0, 4.0], [1.0, 2.0], [3.0, 5.0],
                     [8.0, 9.0]])
    assert profile._union(rows).tolist() == [[0.0, 6.0], [8.0, 9.0]]
    assert profile._union(np.zeros((0, 2))).shape == (0, 2)
