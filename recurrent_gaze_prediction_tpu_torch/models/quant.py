"""Int8 quantized C3D inference (serving-time post-training quantization):
the port's counterpart of the JAX package's `models/quant.py`.

The scheme is the JAX package's (`models/quant.py:11-20` there):
  * weights: symmetric per-output-channel int8, wscale = max|w_c| / 127,
    floored at 1e-12;
  * activations: a symmetric per-tensor int8 scale per layer, from absmax
    calibration of the f32 tower (TF32 off) on calibration clips;
  * conv: int8 x int8 -> int32, then dequant + bias + relu + requant to
    the next layer's scale in the conv's epilogue; int8 is carried between
    layers;
  * max-pooling runs on the int8 tensor (monotonic: it commutes with the
    requant);
  * conv5b dequantizes to f32, so the gaze model's input is unchanged.

Each layer is one launch of kernel Q1 and each pool one of Q1-pool
(`ops/kernels/conv3d_int8.py`); on CPU tensors their plain versions run.
Only the conv tower (conv1a..conv5b, the part the gaze models read) is
quantized.

Qparams are a dict per conv layer: `{name}_wq` int8 packed [Cout, Kpad]
(the kernel's layout, packed once here), `{name}_wscale` f32 [Cout],
`{name}_b` f32 [Cout] on the weights' device, and `{name}_xscale`, the
layer's input scale, an f32 0-d CPU tensor (a host scalar the kernel takes
by value). `bridge.qparams_from_jax` / `qparams_to_jax` convert from and to
the JAX package's (DHWIO `wq`; the keys of a bundle's `qparams_int8.npz`).
The tower's clips and features keep `models/c3d.py`'s layouts: clips
[N, 3, 16, 112, 112] (channels-last-3d memory, i.e. NDHWC, from
`preprocess_frames`), conv5b [N, 512, 2, 7, 7].
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.kernels.conv3d_int8 import (conv3d_int8, maxpool3d_int8,
                                       pack_weights, quantize)
from ..ops.layers import conv3d, max_pool3d
from ..utils import log, tf32_off
from . import c3d as c3d_model

_QMAX = 127.0
CONV_NAMES = tuple(name for name, _ in c3d_model.CONV_LAYERS)


def calibrate_c3d(params: dict, calib_clips: torch.Tensor) -> dict:
    """Record per-layer input activation scales on calibration clips.

    calib_clips: [N, 3, 16, 112, 112] ALREADY preprocessed network inputs
    (`c3d.preprocess_frames`). Runs the f32 tower with TF32 off and returns
    {layer_name: float scale}, scale = max|input| / 127 (symmetric absmax
    calibration)."""
    scales = {}
    with tf32_off(), torch.inference_mode():
        x = calib_clips.float()
        for name in CONV_NAMES:
            scales[name] = float(x.abs().max()) / _QMAX
            x = torch.relu(conv3d(x, params[f"{name}_w"],
                                  params[f"{name}_b"]))
            if name == "conv5b":
                break
            if name in c3d_model.POOLS:
                x = max_pool3d(x, *c3d_model.POOLS[name])
    return scales


def quantize_c3d(params: dict, act_scales: dict) -> dict:
    """f32 conv-tower weights (the port's [out, in, kd, kh, kw]) +
    calibrated activation scales -> int8 qparams (module docstring), with
    `wq` and `wscale` bit-identical to the JAX package's."""
    q = {}
    for name in CONV_NAMES:
        w = params[f"{name}_w"].detach().float().cpu().numpy()
        dev = params[f"{name}_w"].device
        wscale = np.abs(w).max(axis=(1, 2, 3, 4)) / _QMAX  # [out]
        wscale = np.maximum(wscale, 1e-12)
        wq = np.clip(np.round(w / wscale[:, None, None, None, None]),
                     -_QMAX, _QMAX).astype(np.int8)
        q[f"{name}_wq"] = torch.from_numpy(pack_weights(wq)).to(dev)
        q[f"{name}_wscale"] = torch.from_numpy(
            wscale.astype(np.float32)).to(dev)
        q[f"{name}_b"] = params[f"{name}_b"].detach().float().to(dev)
        q[f"{name}_xscale"] = torch.tensor(np.float32(act_scales[name]))
    return q


def apply_int8(qparams: dict, clips: torch.Tensor) -> torch.Tensor:
    """Quantized conv tower: preprocessed clips [N, 3, 16, 112, 112] ->
    conv5b features [N, 512, 2, 7, 7] f32 (the contract of
    `c3d.apply(..., feature_layer='conv5b')`)."""
    x = clips.permute(0, 2, 3, 4, 1)  # NDHWC: free for channels-last-3d
    xs = [float(qparams[f"{name}_xscale"]) for name in CONV_NAMES]
    x_q = quantize(x.float(), xs[0]).contiguous()
    for i, name in enumerate(CONV_NAMES):
        last = name == "conv5b"
        y = conv3d_int8(x_q, qparams[f"{name}_wq"],
                        qparams[f"{name}_wscale"], qparams[f"{name}_b"],
                        xs[i], None if last else xs[i + 1])
        if last:
            return y.permute(0, 4, 1, 2, 3)
        x_q = y
        if name in c3d_model.POOLS:
            x_q = maxpool3d_int8(x_q, *c3d_model.POOLS[name])
    raise AssertionError("unreachable")


def make_int8_c3d_forward(qparams: dict):
    """`fn(_, clips) -> conv5b [N, 512, 2, 7, 7]`, the `c3d_forward` hook
    of `pipeline.extract_and_predict`, with the quantized params closed
    over (the ignored first argument keeps the (params, clips) calling
    convention)."""

    def fn(_unused_params, clips):
        return apply_int8(qparams, clips)

    return fn


def quantize_for_pipeline(c3d_params: dict, *,
                          calib_clips: Optional[torch.Tensor] = None,
                          seed: int = 0) -> dict:
    """One-call quantization for serving: calibrate (on `calib_clips`, or
    on synthetic pixel noise drawn with `np.random.RandomState(seed)`, the
    JAX package's clips) and return int8 qparams on the weights'
    device."""
    if calib_clips is None:
        log.warn(
            "int8 calibration falling back to synthetic uniform-noise clips; "
            "deep-layer activation ranges under noise can differ from real "
            "video. Pass calib_clips (real decoded clips) for production "
            "bundles.")
        rng = np.random.RandomState(seed)
        raw = rng.randint(0, 255, (4, 16, 128, 171, 3)).astype(np.float32)
        dev = c3d_params["conv1a_w"].device
        calib_clips = c3d_model.preprocess_frames(
            torch.from_numpy(raw).to(dev))
    scales = calibrate_c3d(c3d_params, calib_clips)
    return quantize_c3d(c3d_params, scales)
