"""The port's spans and counters (`train/profiler.py`) on the CPU: off
while no profiler records, the records' tree, requests and threads while
one does, their times against the trace's ranges, and the spans that the
train steps (gaze_grcn's, the cascade's and the raw-video one), the served
fused program and the prefetch thread open."""

import json
import threading

import numpy as np
import pytest
import torch

from recurrent_gaze_prediction_tpu_torch import registry
from recurrent_gaze_prediction_tpu_torch.config import OptimizerConfig
from recurrent_gaze_prediction_tpu_torch.data import synthetic
from recurrent_gaze_prediction_tpu_torch.data.prefetch import (
    prefetch_batches, stream_casts)
from recurrent_gaze_prediction_tpu_torch.models import c3d, pipeline
from recurrent_gaze_prediction_tpu_torch.serving.bundle import (
    fused_predict_fn, load_bundle, save_bundle)
from recurrent_gaze_prediction_tpu_torch.train import (FusedTrainState,
                                                       create_train_state,
                                                       make_train_step,
                                                       profiler)

TINY = dict(dim_cnn_proj=8, rnn_state_size=8, compute_dtype="float32",
            n_lstm_steps=2, batch_size=2)
# conv5b keeps its 512 channels: the pipeline folds them to 1024
TINY_TOWER = (8, 8, 16, 16, 16, 16, 16, 512)
GAZE = ("gaze.projection", "gaze.recurrence", "gaze.decoder")


@pytest.fixture
def recording():
    """A CPU profiler recording around the test's body, the buffer cleared
    first and after."""
    profiler.clear()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        yield prof
    finally:
        if profiler.enabled():
            prof.stop()
        profiler.clear()


def _model(name="gaze_grcn", **kw):
    return registry.create_model(name, device="cpu", **dict(TINY, **kw))


def _tiny_tower():
    g = torch.Generator().manual_seed(3)
    params, cin = {}, 3
    for (name, _), cout in zip(c3d.CONV_LAYERS, TINY_TOWER):
        params[f"{name}_w"] = torch.randn((cout, cin, 3, 3, 3), generator=g) \
            / (27 * cin) ** 0.5
        params[f"{name}_b"] = torch.zeros(cout)
        cin = cout
    return params


def _tree(records):
    """{name: (parent's name, request)} of records with unique names."""
    by_id = {r["id"]: r for r in records}
    names = [r["name"] for r in records]
    assert len(names) == len(set(names)), names
    return {r["name"]: (by_id[r["parent"]]["name"] if r["parent"] else None,
                        r["request"]) for r in records}


def test_off_returns_the_shared_no_op_and_records_nothing():
    assert not profiler.enabled()
    profiler.clear()
    first, second = profiler.span("a"), profiler.span("b", request=3)
    assert first is second
    with first as opened:
        profiler.count("c", 5)
    assert opened is None
    assert profiler.records() == [] and profiler.counts() == {}
    assert profiler.dropped() == 0


def test_on_records_tree_requests_threads_and_counts(recording):
    seen = {}

    def other():
        with profiler.span("worker", request=9):
            profiler.count("items", 2)
        seen["thread"] = threading.get_native_id()

    with profiler.span("root", request=7):
        with profiler.span("child"):
            with profiler.span("grandchild", request=8):
                profiler.count("items", 3)
        t = threading.Thread(target=other)
        t.start()
        t.join()
    recording.stop()
    with profiler.span("after"):   # the profiler has stopped
        pass
    recs = profiler.records()
    # in the order they closed, innermost first
    assert [r["name"] for r in recs] == ["grandchild", "child", "worker",
                                         "root"]
    assert _tree(recs) == {"root": (None, 7), "child": ("root", 7),
                           "grandchild": ("child", 8),
                           "worker": (None, 9)}
    main = threading.get_native_id()
    assert {r["name"]: r["thread"] for r in recs} == {
        "root": main, "child": main, "grandchild": main,
        "worker": seen["thread"]}
    assert seen["thread"] != main
    assert all(r["start_ns"] <= r["end_ns"] for r in recs)
    by = {r["name"]: r for r in recs}
    assert by["root"]["start_ns"] <= by["child"]["start_ns"] \
        and by["child"]["end_ns"] <= by["root"]["end_ns"]
    assert by["grandchild"]["counts"] == {"items": 3}
    assert by["worker"]["counts"] == {"items": 2}
    assert by["root"]["counts"] is None
    assert profiler.counts() == {"items": 5}


def _annotation_gaps_us(tmp_path, attempt: int) -> list:
    """One traced round of nested spans with work in them -> each record's
    larger distance (start or end) from its range in the exported trace,
    us."""
    profiler.clear()
    x = torch.ones(64, 64)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i in range(20):
            with profiler.span(f"outer{i}"):
                x = x @ x / 64
                with profiler.span(f"inner{i}"):
                    x = torch.relu(x)
    path = tmp_path / f"trace{attempt}.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base_us = trace["baseTimeNanoseconds"] / 1e3
    ranges = {e["name"]: e for e in trace["traceEvents"]
              if e.get("cat") == "user_annotation"}
    gaps = []
    for r in profiler.records():
        e = ranges[r["name"]]
        start = float(e["ts"]) + base_us
        gaps.append(max(abs(r["start_ns"] / 1e3 - start),
                        abs(r["end_ns"] / 1e3 - (start + float(e["dur"])))))
    profiler.clear()
    assert len(gaps) == 40
    return gaps


def test_records_lie_on_the_trace_clock(tmp_path):
    """Every record within 0.1 ms of its `user_annotation` range. A
    process preempted between the range's stamp and the record's clock
    read is off by the preemption, so a round is retried (at most three)
    before the test fails."""
    worst = []
    for attempt in range(3):
        worst.append(max(_annotation_gaps_us(tmp_path, attempt)))
        if worst[-1] <= 100.0:
            break
    assert worst[-1] <= 100.0, worst


def test_cap_drops_and_counts(recording, monkeypatch):
    monkeypatch.setattr(profiler, "CAP", 3)
    for i in range(5):
        with profiler.span(f"s{i}"):
            pass
    assert [r["name"] for r in profiler.records()] == ["s0", "s1", "s2"]
    assert profiler.dropped() == 2
    profiler.clear()
    assert profiler.records() == [] and profiler.dropped() == 0


def test_threads_lose_no_record_count_or_drop(recording, monkeypatch):
    """More threads than cores, switching every microsecond: every span is
    either recorded or counted as dropped, ids are unique, each thread's
    children name their own thread's parent, and no count is lost."""
    import sys

    n_threads, n_spans = 16, 200
    monkeypatch.setattr(profiler, "CAP", n_threads * n_spans)  # 2 a loop
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(k):
        for i in range(n_spans // 2):
            with profiler.span("outer", request=(k, i)):
                with profiler.span("inner"):
                    profiler.count("n", 1)

    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    recs = profiler.records()
    assert len(recs) == n_threads * n_spans and profiler.dropped() == 0
    assert len({r["id"] for r in recs}) == len(recs)
    outer = {r["id"]: r for r in recs if r["name"] == "outer"}
    for r in recs:
        if r["name"] == "inner":
            parent = outer[r["parent"]]
            assert parent["thread"] == r["thread"]
            assert r["request"] == parent["request"]
            assert r["counts"] == {"n": 1}
    assert profiler.counts() == {"n": n_threads * n_spans // 2}
    # past the cap: the records kept and the drops add up to every span
    profiler.clear()
    monkeypatch.setattr(profiler, "CAP", n_threads * n_spans // 3)
    threads = [threading.Thread(target=work, args=(k,))
               for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(profiler.records()) == profiler.CAP
    assert len(profiler.records()) + profiler.dropped() == \
        n_threads * n_spans


def test_start_trace_clears_and_profile_steps_labels_each_step(tmp_path):
    profiler.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiler.span("before"):
            pass
    assert [r["name"] for r in profiler.records()] == ["before"]
    x = torch.ones(8, 8)
    prof = profiler.profile_steps(lambda a: a @ a, (x,), 3,
                                  str(tmp_path / "trace"))
    assert [r["name"] for r in profiler.records()] == [
        "step_0", "step_1", "step_2"]
    keys = {e.key: e.count for e in prof.key_averages()}
    assert keys.get("step_0") == keys.get("step_1") == keys.get(
        "step_2") == 1
    profiler.clear()


@pytest.mark.parametrize("flip", [False, True])
def test_train_step_tree(recording, flip):
    """One `make_train_step` step: the root carries the step it produces;
    flip, forward (the gaze model's three spans), backward and optimizer
    under it; at most 10 spans a step with the input's two."""
    model = _model(use_flip_batch=flip)
    state, tx = create_train_state(model, OptimizerConfig())
    step = make_train_step(model, tx)
    rng = np.random.RandomState(0)
    batch = {"c3d": torch.from_numpy(rng.rand(2, 2, 1024, 7, 7)).float(),
             "gazemaps": torch.from_numpy(rng.rand(2, 2, 49, 49)).float()}
    state.step = 41
    step(state, batch, torch.Generator().manual_seed(0))
    recording.stop()
    tree = _tree(profiler.records())
    want = {"train.step": (None, 42), "train.forward": ("train.step", 42),
            "train.backward": ("train.step", 42),
            "train.optimizer": ("train.step", 42),
            **{n: ("train.forward", 42) for n in GAZE}}
    if flip:
        want["train.flip"] = ("train.step", 42)
    assert tree == want
    assert len(tree) + 2 <= 10


def test_fused_train_step_tree(recording):
    """One `make_fused_train_step` step from raw video, the tower frozen:
    the same names, the pipeline's tower and head under the forward."""
    model = _model()
    tower = _tiny_tower()
    state, tx = create_train_state(model, OptimizerConfig())
    fstate = FusedTrainState(params=state.params,
                             opt_state=pipeline.init_fused_opt_state(
                                 tx, state.params), c3d_params=tower)
    step = pipeline.make_fused_train_step(model, tx, use_flip=True,
                                          compute_dtype=None)
    rng = np.random.RandomState(1)
    batch = {"video": torch.from_numpy(rng.randint(
        0, 256, (2, 16, 64, 80, 3)).astype(np.float32)),
        "gazemaps": torch.from_numpy(rng.rand(2, 1, 49, 49)).float()}
    step(fstate, batch, torch.Generator().manual_seed(0))
    recording.stop()
    assert _tree(profiler.records()) == {
        "train.step": (None, 1), "train.flip": ("train.step", 1),
        "train.forward": ("train.step", 1),
        "pipeline.tower": ("train.forward", 1),
        "pipeline.head": ("train.forward", 1),
        **{n: ("pipeline.head", 1) for n in GAZE},
        "train.backward": ("train.step", 1),
        "train.optimizer": ("train.step", 1)}


CASCADE = ("gaze.projection", "gaze.recurrence", "gaze.upsample",
           "gaze.top_recurrence", "gaze.decoder")


def _cascade_batch(t=2):
    rng = np.random.RandomState(2)
    return {"c3d": torch.from_numpy(rng.rand(2, t, 1024, 7, 7)).float(),
            "gazemaps": torch.from_numpy(rng.rand(2, t, 49, 49)).float()}


def test_cascade_train_step_tree_and_plain_steps(recording):
    """One `make_train_step` step of gaze_grcn_cascade (both cells on
    `ConvGRU.scan`, rematerialized): its five spans under the forward, and
    `recurrence.plain_steps` counted once per scan, on the scan's span:
    2 T a step, none from the backward's recomputed steps."""
    model = _model("gaze_grcn_cascade", loss_type="l2", n_lstm_steps=3)
    state, tx = create_train_state(model, OptimizerConfig())
    step = make_train_step(model, tx)
    step(state, _cascade_batch(t=3), torch.Generator().manual_seed(0))
    recording.stop()
    recs = profiler.records()
    assert model.last_route == "scan" and model.cfg.remat_cells
    assert _tree(recs) == {
        "train.step": (None, 1), "train.flip": ("train.step", 1),
        "train.forward": ("train.step", 1),
        "train.backward": ("train.step", 1),
        "train.optimizer": ("train.step", 1),
        **{n: ("train.forward", 1) for n in CASCADE}}
    counted = {r["name"]: r["counts"] for r in recs if r["counts"]}
    assert counted == {"gaze.recurrence": {"recurrence.plain_steps": 3},
                       "gaze.top_recurrence": {"recurrence.plain_steps": 3}}
    assert profiler.counts() == {"recurrence.plain_steps": 6}


def test_cascade_outputs_bitwise_with_spans_on_and_off():
    """The cascade's train-mode maps (dropout drawn from one seed) and
    their gradient, with no profiler recording and with one recording:
    bitwise equal."""
    model = _model("gaze_grcn_cascade", loss_type="l2")
    c3d = _cascade_batch()["c3d"]

    def forward():
        model.zero_grad()
        out = model(None, c3d, train=True,
                    generator=torch.Generator().manual_seed(4))
        out.square().sum().backward()
        return out.detach(), model.up_w.grad.clone()

    assert not profiler.enabled()
    off = forward()
    profiler.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        on = forward()
    assert {r["name"] for r in profiler.records()} == set(CASCADE)
    profiler.clear()
    assert torch.equal(off[0], on[0]) and torch.equal(off[1], on[1])


def test_fused_predict_tree(tmp_path):
    """Two calls of the bundle's `fused` program: a root per call with the
    call's number, the upload and the pipeline under it, 7 spans a
    request on the caller's thread."""
    save_bundle(str(tmp_path), _model(), c3d_params=_tiny_tower(),
                num_frames=16, video_hw=(64, 80), video_dtype="uint8",
                c3d_compute_dtype="float32")
    predict = fused_predict_fn(load_bundle(str(tmp_path), device="cpu"))
    video = np.random.RandomState(5).randint(
        0, 256, (1, 16, 64, 80, 3)).astype(np.uint8)
    predict(video)   # call 0, not recorded
    profiler.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        predict(video)
    recs = profiler.records()
    profiler.clear()
    assert _tree(recs) == {
        "serve.predict": (None, 1), "serve.upload": ("serve.predict", 1),
        "pipeline.tower": ("serve.predict", 1),
        "pipeline.head": ("serve.predict", 1),
        **{n: ("pipeline.head", 1) for n in GAZE}}
    assert len({r["thread"] for r in recs}) == 1 and len(recs) <= 7


def test_prefetch_put_and_wait_join_by_batch(recording):
    """The worker's `input.put` and the consumer's `input.wait` of a batch
    carry its number, on their own threads; `input.bytes` is the cast
    batch's bytes."""
    data = synthetic.make_clip_windows(6, 2, seed=0)
    batches = prefetch_batches(data, 2, device="cpu", buffer_size=1,
                               cast=stream_casts(torch.bfloat16))
    got = [next(batches) for _ in range(3)]
    recording.stop()
    batches.close()
    recs = profiler.records()
    waits = {r["request"]: r for r in recs if r["name"] == "input.wait"}
    puts = {r["request"]: r for r in recs if r["name"] == "input.put"}
    assert sorted(waits) == [0, 1, 2] and {0, 1, 2} <= set(puts)
    assert all(r["parent"] is None for r in recs)
    for k, batch in enumerate(got):
        assert batch["c3d"].dtype == torch.bfloat16
        assert puts[k]["counts"] == {
            "input.bytes": sum(t.nbytes for t in batch.values())}
        assert puts[k]["thread"] != waits[k]["thread"]
        assert puts[k]["start_ns"] <= waits[k]["end_ns"]
    assert profiler.counts()["input.bytes"] >= 3 * puts[0]["counts"][
        "input.bytes"]
