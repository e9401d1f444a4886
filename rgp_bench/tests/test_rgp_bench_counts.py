"""The frozen yardstick: the published peaks and the counts of operations
and bytes, against the figures the kernel tables were built on."""

import pytest

from rgp_bench.counts import c3d, gaze, peaks

TOWER = [64, 128, 256, 256, 512, 512, 512, 512]
MODEL = {"dim_feature": 1024, "dim_cnn_proj": 512, "rnn_state_size": 128}


def test_peaks_are_the_h100_sxm_data_sheet():
    assert peaks.OPS_PER_S == {"bfloat16": 989e12, "int8": 1979e12}
    assert peaks.BYTES_PER_S == 3.35e12


def test_int8_tower_at_the_served_160_clips():
    # 16 videos of 160 frames: 12,319 GOP, bound by operations at 6.225 ms
    ops = c3d.ops(TOWER, 160)
    assert ops == 12_318_922_506_240
    assert c3d.ops(TOWER, 1) * 160 == ops
    nbytes = c3d.int8_bytes(TOWER, 160)
    assert nbytes == 160 * 16 * 112 * 112 * 3 + sum(
        27 * cin * cout + 8 * cout
        for cin, cout in zip([3] + TOWER[:-1], TOWER)) + 4 * 160 * 512 * 98
    assert peaks.least_seconds(ops, nbytes, "int8") == pytest.approx(
        6.2248e-3, rel=1e-4)


def test_tower_layer_shapes():
    shapes = {name: (dhw, cout) for name, dhw, cout in
              c3d.layer_inputs(TOWER)}
    assert shapes["conv1a"] == ((16, 112, 112, 3), 64)
    assert shapes["conv2a"] == ((16, 56, 56, 64), 128)
    assert shapes["conv3b"] == ((8, 28, 28, 256), 256)
    assert shapes["conv5b"] == ((2, 7, 7, 512), 512)
    assert c3d.conv5b_elements(TOWER, 1) == 512 * 2 * 7 * 7


def test_b1_count_at_b8():
    # kernel B1 at B=8, T=42, U=128: 14.57 GFLOP
    assert gaze.recurrence_ops(42, 8, 128) == 14_566_293_504


def test_recurrence_train_least_time_is_three_passes():
    least = gaze.recurrence_train_least_s(42, 28, 128, 989e12, 3.35e12)
    assert least == pytest.approx(3 * gaze.recurrence_ops(42, 28, 128)
                                  / 989e12)


@pytest.mark.parametrize("cell, gates", [("convgru", 3), ("convlstm", 4)])
def test_head_contractions(cell, gates):
    parts = gaze.forward_parts(MODEL, cell)
    assert parts == {"projection": 2 * 49 * 1024 * 512,
                     "input_convs": 2 * 49 * 9 * 512 * gates * 128,
                     "state_convs": 2 * 49 * 9 * 128 * gates * 128,
                     "decoder": 2 * 49 * 128 * 2401}
    frames = 28 * 42
    assert gaze.forward_ops(MODEL, cell, frames) == frames * sum(
        parts.values())
    # backward: weight gradients everywhere, input gradients but for the
    # projection's input (the features)
    assert gaze.train_ops(MODEL, cell, frames) == frames * (
        2 * parts["projection"] + 3 * (parts["input_convs"]
                                       + parts["state_convs"]
                                       + parts["decoder"]))
