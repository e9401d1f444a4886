"""The port's input path on the CPU: `data/prefetch.py` (the batches it
yields, its worker's lifetime and errors) and `train.fit` fed by it."""

import threading
import time

import numpy as np
import pytest
import torch

from recurrent_gaze_prediction_tpu_torch import registry
from recurrent_gaze_prediction_tpu_torch.config import ExperimentConfig
from recurrent_gaze_prediction_tpu_torch.data import synthetic
from recurrent_gaze_prediction_tpu_torch.data.prefetch import (
    device_put_batch, prefetch_batches, stream_casts)
from recurrent_gaze_prediction_tpu_torch.train import (
    create_train_state, fit, flip_half_batch)

CPU = torch.device("cpu")


def _clips(n=5, t=2, seed=0):
    return synthetic.make_clip_windows(n, t, seed=seed)


def _workers():
    return [th for th in threading.enumerate()
            if th.name == "prefetch_batches" and th.is_alive()]


def _no_worker_within(seconds: float) -> bool:
    deadline = time.monotonic() + seconds
    while _workers() and time.monotonic() < deadline:
        time.sleep(0.02)
    return not _workers()


@pytest.mark.parametrize("cast", [None, torch.bfloat16])
def test_prefetched_batches_equal_the_next_batch_sequence(cast):
    """7 batches of 2 from 5 clips (the epoch wraps, as next_batch does),
    cast on the host as the inline path casts them."""
    got = list(prefetch_batches(_clips(), 2, device="cpu",
                                cast=stream_casts(cast), max_batches=7))
    assert len(got) == 7
    ref = _clips()
    for batch in got:
        want = ref.next_batch(2)
        assert set(batch) == {"frames", "gazemaps", "fixationmaps", "c3d",
                              "pupils"}
        inline = device_put_batch(want, CPU, stream_casts(cast))
        for key, value in batch.items():
            dtype = cast if cast and key in ("frames", "c3d") \
                else torch.float32
            assert value.dtype == dtype, key
            assert torch.equal(value, inline[key]), key
            assert torch.equal(value, torch.from_numpy(want[key]).to(dtype))


def test_device_put_batch_drops_names_and_ragged_maps():
    batch = _clips().next_batch(2)
    batch["fixationmaps"] = np.empty(2, dtype=object)
    out = device_put_batch(batch, CPU)
    assert set(out) == {"frames", "gazemaps", "c3d", "pupils"}


@pytest.mark.parametrize("how", ["close", "drop"])
def test_an_abandoned_generator_leaves_no_live_worker(how):
    gen = prefetch_batches(_clips(), 2, device="cpu", buffer_size=1)
    next(gen)
    time.sleep(0.2)  # the worker blocks on a full queue
    assert _workers()
    if how == "close":
        gen.close()
    else:
        del gen
    assert _no_worker_within(1.0)


def test_a_worker_exception_is_raised_in_the_consumer():
    class Broken:
        calls = 0

        def next_batch(self, batch_size):
            Broken.calls += 1
            if Broken.calls == 2:
                raise OSError("disk gone")
            return _clips().next_batch(batch_size)

    gen = prefetch_batches(Broken(), 2, device="cpu")
    next(gen)
    with pytest.raises(OSError, match="disk gone"):
        next(gen)
    assert _no_worker_within(1.0)


def _fit(train_iterator=None):
    model = registry.create_model(
        "gaze_grcn", device="cpu", dim_feature=1024, dim_cnn_proj=8,
        rnn_state_size=8, n_lstm_steps=2, batch_size=2,
        compute_dtype="float32", generator=torch.Generator().manual_seed(1))
    exp = ExperimentConfig()
    exp.model = model.cfg
    exp.schedule.max_steps = 4
    state, tx = create_train_state(model, exp.optimizer)
    data = synthetic.make_splits(n_train=3, n_valid=2, n_test=2, t=2)
    if train_iterator == "prefetch":
        train_iterator = prefetch_batches(data.train, 2, device="cpu",
                                          max_batches=4)
    return fit(model, state, tx, data, exp, train_iterator=train_iterator)


def test_fit_with_prefetched_batches_equals_inline():
    """Flip and dropout on; the same generator draws in both runs."""
    inline, fed = _fit(), _fit("prefetch")
    assert inline.step == fed.step == 4
    for name, p in inline.params.items():
        assert torch.equal(p, fed.params[name]), name


def test_fit_stops_when_the_iterator_runs_dry():
    state = _fit(iter([]))
    assert state.step == 0


def test_pupils_pass_the_copy_and_the_flip_unchanged():
    """`batch["pupils"]` [B, T] (the pupil prototypes' loss target) goes
    through the prefetch thread as it is, and the half-batch flip mirrors
    frames, maps and features of exactly B//2 samples but leaves the pupils
    (a scalar per frame) alone."""
    raw = _clips(n=6).next_batch(6)
    batch = next(prefetch_batches(_clips(n=6), 6, device="cpu",
                                  max_batches=1))
    assert torch.equal(batch["pupils"], torch.from_numpy(raw["pupils"]))
    flipped = flip_half_batch(batch, torch.Generator().manual_seed(0))
    assert torch.equal(flipped["pupils"], batch["pupils"])
    mirrored = [not torch.equal(flipped["gazemaps"][i], batch["gazemaps"][i])
                for i in range(6)]
    assert sum(mirrored) == 3
    for i, m in enumerate(mirrored):
        want = batch["c3d"][i].flip(-1) if m else batch["c3d"][i]
        assert torch.equal(flipped["c3d"][i], want)
