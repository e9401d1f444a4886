"""`correct` at a size the CPU holds: true for the sound program, false for
the control (the next precision below the configuration's in the
program's place) and for the program broken underneath the timed path,
once for each fault the cell can have. The harness's look for a card is
skipped (`run.run_cell` on the CPU); the rest of a run is driven."""

from __future__ import annotations

import pytest
import torch

from rgp_bench import run

SEED = 2**31 + 97


def _run(root, workload, variant="program"):
    return run.run_cell(root, workload, SEED, 0.5, False, "cpu",
                        variant=variant)


@pytest.mark.parametrize("workload", ["grcn_int8_video", "lstm_bf16_video",
                                      "grcn_train_b28"])
def test_sound_program_is_correct_and_the_control_is_not(tiny_root,
                                                         workload):
    sound = _run(tiny_root, workload)
    assert sound["correct"], sound["checks"]
    control = _run(tiny_root, workload, "control")
    assert not control["correct"], control["checks"]


def _wrap_video_program(monkeypatch, alter):
    """Replace the served program's answer by `alter(maps, state)`."""
    from recurrent_gaze_prediction_tpu_torch.serving import bundle

    real = bundle.fused_int8_predict_fn

    def broken(model):
        fn = real(model)
        state = {}

        def predict(video):
            return alter(fn(video), state)

        return predict

    monkeypatch.setattr(bundle, "fused_int8_predict_fn", broken)


def _altered(maps, state):
    return torch.roll(maps, 3, dims=-1)


def _half_batch(maps, state):
    half = maps.shape[0] // 2
    out = maps.clone()
    out[half:] = maps[:half].mean(0, keepdim=True)
    return out


def _stale(maps, state):
    state.setdefault("first", maps)
    return state["first"]


@pytest.mark.parametrize("fault", [_altered, _half_batch, _stale],
                         ids=["answer_altered", "half_batch", "stale_answer"])
def test_video_faults_are_refused(tiny_root, monkeypatch, fault):
    _wrap_video_program(monkeypatch, fault)
    result = _run(tiny_root, "grcn_int8_video")
    assert not result["correct"], result["checks"]


def _unchanged(monkeypatch):
    from recurrent_gaze_prediction_tpu_torch.train import state

    monkeypatch.setattr(state.Optimizer, "apply",
                        lambda self, params, grads, opt_state, norm=None:
                        None)


def _half_rows(monkeypatch):
    from recurrent_gaze_prediction_tpu_torch.train import state

    real = state.loss_and_grads

    def half(model, params, batch, generator):
        b = next(iter(batch.values())).shape[0]
        return real(model, params, {k: v[:b // 2] for k, v in batch.items()},
                    generator)

    monkeypatch.setattr(state, "loss_and_grads", half)


def _doubled_grad(monkeypatch):
    from recurrent_gaze_prediction_tpu_torch.train import state

    real = state.loss_and_grads

    def doubled(model, params, batch, generator):
        loss, grads = real(model, params, batch, generator)
        return loss, [grads[0] * 2] + grads[1:]

    monkeypatch.setattr(state, "loss_and_grads", doubled)


@pytest.mark.parametrize("fault", [_unchanged, _half_rows, _doubled_grad],
                         ids=["state_unchanged", "half_batch",
                              "gradient_altered"])
def test_train_faults_are_refused(tiny_root, monkeypatch, fault):
    fault(monkeypatch)
    result = _run(tiny_root, "grcn_train_b28")
    assert not result["correct"], result["checks"]
