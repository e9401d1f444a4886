"""The C3D tower to conv5b (Tran et al., ICCV 2015, the Sports-1M model the
reference release extracts its features with), plainly.

    pixels [N, 16, 128, 171, 3] 0..255 -> center crop 112 -> minus the
    mean pixel -> conv1a pool(1,2,2) conv2a pool(2,2,2) conv3a conv3b pool
    conv4a conv4b pool conv5a conv5b, every conv 3x3x3 pad 1 + relu
    -> conv5b [N, 512, 2, 7, 7] -> [N, 1024, 7, 7] (channel c, depth d at
    c * 2 + d, the release's fold of the blob)

`tower_f32` computes it in float32. `tower_int` computes the
post-training-quantized tower: symmetric per-output-channel weights
(scale max|w| / qmax), a symmetric per-tensor scale per layer input from
absmax calibration of the float32 tower (`calibrate`), the integer conv
summed exactly in float64, then dequantize, bias, relu and requantize to
the next layer's scale (round half to even), pools on the integers,
conv5b dequantized to float32. qmax = 127 is int8; 7 is int4.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import no_tf32

LAYERS = ("conv1a", "conv2a", "conv3a", "conv3b", "conv4a", "conv4b",
          "conv5a", "conv5b")
POOL_AFTER = {"conv1a": (1, 2, 2), "conv2a": (2, 2, 2), "conv3b": (2, 2, 2),
              "conv4b": (2, 2, 2)}


def preprocess(frames: torch.Tensor, crop: int, mean_pixel: float
               ) -> torch.Tensor:
    """[N, 16, H, W, 3] pixels already at the tower's 128x171 -> network
    input [N, 3, 16, crop, crop] float32."""
    h, w = frames.shape[2:4]
    top, left = (h - crop) // 2, (w - crop) // 2
    x = frames[:, :, top:top + crop, left:left + crop].float() - mean_pixel
    return x.permute(0, 4, 1, 2, 3).contiguous()


def fold(conv5b: torch.Tensor) -> torch.Tensor:
    return conv5b.reshape(conv5b.shape[0], -1, *conv5b.shape[3:])


def _pool(x: torch.Tensor, name: str) -> torch.Tensor:
    if name not in POOL_AFTER:
        return x
    k = POOL_AFTER[name]
    if any(s % kk for s, kk in zip(x.shape[2:], k)):
        raise ValueError(f"the reference pools even sizes only: {x.shape}")
    return F.max_pool3d(x, k, k)


def tower_f32(params: dict, clips: torch.Tensor, *,
              rounding=None) -> torch.Tensor:
    """conv5b features [N, 512, 2, 7, 7] float32. `rounding(t)` (None: no
    rounding) is applied to every conv's operands and output: the control
    rounds them to a lower precision."""
    r = rounding or (lambda t: t)
    x = clips.float()
    with no_tf32():
        for name in LAYERS:
            x = torch.relu(r(F.conv3d(r(x), r(params[f"{name}_w"].float()),
                                      params[f"{name}_b"].float(),
                                      padding=1)))
            x = _pool(x, name)
    return x


def calibrate(params: dict, clips: torch.Tensor, qmax: float) -> dict:
    """Each layer's input scale: max|input| / qmax over the calibration
    clips, through the float32 tower."""
    scales = {}
    x = clips.float()
    with no_tf32():
        for name in LAYERS:
            scales[name] = float(x.abs().max()) / qmax
            if name == LAYERS[-1]:
                break
            x = _pool(torch.relu(F.conv3d(x, params[f"{name}_w"].float(),
                                          params[f"{name}_b"].float(),
                                          padding=1)), name)
    return scales


def quantize_weights(params: dict, qmax: float) -> dict:
    """{name: (integer weights as float64, per-channel scale float32)}."""
    out = {}
    for name in LAYERS:
        w = params[f"{name}_w"].float()
        scale = (w.abs().amax(dim=(1, 2, 3, 4)) / qmax).clamp_min(1e-12)
        q = torch.round(w / scale[:, None, None, None, None]).clamp(
            -qmax, qmax)
        out[name] = (q.double(), scale)
    return out


def _requant(y: torch.Tensor, scale: float, qmax: float) -> torch.Tensor:
    s = torch.tensor(scale, dtype=torch.float32, device=y.device)
    return torch.round(y / s).clamp(-qmax, qmax)


def tower_int(params: dict, scales: dict, clips: torch.Tensor,
              qmax: float) -> torch.Tensor:
    """conv5b features [N, 512, 2, 7, 7] float32 of the quantized tower at
    `qmax` (127: int8, 7: int4), from float32 weights and calibrated input
    scales."""
    qw = quantize_weights(params, qmax)
    x = _requant(clips.float(), scales[LAYERS[0]], qmax)
    for i, name in enumerate(LAYERS):
        wq, wscale = qw[name]
        acc = F.conv3d(x.double(), wq, padding=1).float()
        alpha = torch.tensor(scales[name], dtype=torch.float32,
                             device=acc.device) * wscale
        y = torch.relu(acc * alpha[None, :, None, None, None]
                       + params[f"{name}_b"].float()[None, :, None, None,
                                                     None])
        if name == LAYERS[-1]:
            return y
        x = _pool(_requant(y, scales[LAYERS[i + 1]], qmax), name)
    raise AssertionError("unreachable")
