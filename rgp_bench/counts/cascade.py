"""The two-level ConvGRU cascade's contractions, from shapes.

Per frame (one timestep of one clip), with P the projection's width, U
and u the bottom and top cells' units, C the upsample's channels, k and K
the cells' kernels, s the upsample's stride and q its kernel:
    projection     2 * 49 * F * P
    bottom input   2 * 49 * k^2 * P * 3U      the hoisted input convs
    bottom state   2 * 49 * k^2 * U * 3U      z|r, then the candidate
    upsample       2 * 49 * q^2 * U * C       each input position scatters
                                              the whole kernel (SAME keeps
                                              (7 s)^2 = 2401 outputs)
    top input      2 * 2401 * K^2 * C * 3u
    top state      2 * 2401 * K^2 * u * 3u
    fc head        2 * 2401 u * W + 2 * (W / 2) * W   (W = fc_width)
A training step adds the backward as `gaze.train_ops` does: each weight's
gradient, and the input's gradient of every contraction but the
projection (whose input is the features). The steps the rematerialized
cells recompute are not counted.
"""

from __future__ import annotations

GRID, MAP = 49, 2401   # the bottom cell's 7x7 positions, the map's 49x49


def forward_parts(model: dict, cascade: dict) -> dict:
    f, p = model["dim_feature"], model["dim_cnn_proj"]
    u, k = cascade["bottom_units"], cascade["bottom_kernel"]
    c, q = cascade["up_channels"], cascade["up_kernel"]
    tu, tk, w = cascade["top_units"], cascade["top_kernel"], cascade[
        "fc_width"]
    return {"projection": 2 * GRID * f * p,
            "bottom_input": 2 * GRID * k * k * p * 3 * u,
            "bottom_state": 2 * GRID * k * k * u * 3 * u,
            "upsample": 2 * GRID * q * q * u * c,
            "top_input": 2 * MAP * tk * tk * c * 3 * tu,
            "top_state": 2 * MAP * tk * tk * tu * 3 * tu,
            "fc_head": 2 * MAP * tu * w + 2 * (w // 2) * w}


def forward_ops(model: dict, cascade: dict, frames: int) -> int:
    return frames * sum(forward_parts(model, cascade).values())


def train_ops(model: dict, cascade: dict, frames: int) -> int:
    """Forward and backward contractions of a train step over `frames`
    frames (B * T)."""
    parts = forward_parts(model, cascade)
    rest = sum(parts.values()) - parts["projection"]
    return frames * (2 * parts["projection"] + 3 * rest)
