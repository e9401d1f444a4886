"""The gaze head's contractions (projection, recurrent cell, decoder) and
the ConvGRU recurrence's least work, from shapes.

Per frame (one timestep of one clip) on the 7x7 grid:
    projection    2 * 49 * F * P
    input convs   2 * 49 * 9 * P * G * U     (G = 3 ConvGRU, 4 ConvLSTM)
    state convs   2 * 49 * 9 * U * G * U
    decoder       2 * 49 * U * 2401, the decoder being linear: the one
                  [49 U, 2401] product it composes to, which is fewer
                  operations than its three deconvolutions
A training step adds the backward: each weight's gradient (one more of
each), and the input's gradient of every contraction whose input needs
one (all but the projection, whose input is the features).
"""

from __future__ import annotations

GATES = {"convgru": 3, "convlstm": 4}


def forward_parts(model: dict, cell: str) -> dict:
    f, p, u = (model["dim_feature"], model["dim_cnn_proj"],
               model["rnn_state_size"])
    g = GATES[cell]
    return {"projection": 2 * 49 * f * p,
            "input_convs": 2 * 49 * 9 * p * g * u,
            "state_convs": 2 * 49 * 9 * u * g * u,
            "decoder": 2 * 49 * u * 2401}


def forward_ops(model: dict, cell: str, frames: int) -> int:
    return frames * sum(forward_parts(model, cell).values())


def train_ops(model: dict, cell: str, frames: int) -> int:
    """Forward and backward contractions of a train step over `frames`
    frames (B * T)."""
    parts = forward_parts(model, cell)
    return frames * (2 * parts["projection"] + 3 * (
        parts["input_convs"] + parts["state_convs"] + parts["decoder"]))


def recurrence_ops(t: int, b: int, units: int) -> int:
    """The ConvGRU recurrence's state convs over T steps of B clips, one
    pass (kernel B1's count)."""
    return 2 * t * b * 49 * 9 * units * 3 * units


def recurrence_train_least_s(t: int, b: int, units: int, peak_ops: float,
                             peak_bytes: float) -> float:
    """The least time of the ConvGRU recurrence in a train step: its
    forward, the backward's state gradient and the state convs' weight
    gradient (three passes of `recurrence_ops`; the gates the backward
    recomputes are not counted), against the bytes: the bf16 input gates
    read, the f32 states written, then the states, their cotangents and
    the gates read and the input gates' f32 cotangents written."""
    n = t * b * 49
    nbytes = (n * (3 * units * 2 + units * 4)
              + n * (2 * units * 4 + 3 * units * 2 + 3 * units * 4)
              + 2 * 9 * units * 3 * units * 4)
    return max(3 * recurrence_ops(t, b, units) / peak_ops,
               nbytes / peak_bytes)
