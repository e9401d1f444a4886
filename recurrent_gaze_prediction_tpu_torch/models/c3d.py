"""C3D, the Sports-1M 3-D ConvNet feature extractor, inside the program:
the port's counterpart of the JAX package's `models/c3d.py`.

    clips [N, 3, 16, 112, 112]  (NCDHW; `preprocess_frames` makes them
                                 from [N, 16, H, W, 3] pixels: 128x171
                                 resize, 112 center crop, mean subtraction)
    conv1a(64)            + pool1 (1,2,2)
    conv2a(128)           + pool2 (2,2,2)
    conv3a(256) conv3b(256) + pool3
    conv4a(512) conv4b(512) + pool4
    conv5a(512) conv5b(512)           <- the gaze models' feature layer
    [+ pool5, fc6(4096), fc7(4096), fc8(487)]

All convs are 3x3x3 with SAME (pad 1) padding. The weights are a dict of
tensors in PyTorch's layouts, which are Caffe's: conv [out, in, kd, kh,
kw], fc [out, in]; `bridge.c3d_params_from_jax` / `c3d_params_to_jax`
convert from and to the JAX package's DHWIO and [in, out]. Activations are
NCDHW, so conv5b's [N, 512, 2, 7, 7] reshapes straight to the channel-major
fold [N, 1024, 7, 7] (`conv5b_to_rgp`). They stay in the memory format of
the input; `preprocess_frames` returns `MEMORY_FORMAT`.

The convs, pools and resize are library calls (cuDNN on the card): the
JAX package computes them outside any Pallas kernel.

Numerics: with a compute dtype (bf16 on the card) every layer's output is
rounded to it, as in the JAX package; with None the tower is f32 with
TF32 off, so it computes what the JAX package's f32 tower does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.layers import conv3d, linear, max_pool3d, resize_bilinear
from ..utils import resolve_device, tf32_off

# (name, out_channels) per conv layer, prototxt order
CONV_LAYERS = (
    ("conv1a", 64),
    ("conv2a", 128),
    ("conv3a", 256), ("conv3b", 256),
    ("conv4a", 512), ("conv4b", 512),
    ("conv5a", 512), ("conv5b", 512),
)
# pools after these layers: (window, stride) in (depth, h, w)
POOLS = {
    "conv1a": ((1, 2, 2), (1, 2, 2)),
    "conv2a": ((2, 2, 2), (2, 2, 2)),
    "conv3b": ((2, 2, 2), (2, 2, 2)),
    "conv4b": ((2, 2, 2), (2, 2, 2)),
    "conv5b": ((2, 2, 2), (2, 2, 2)),  # pool5, only for the fc path
}
FC_LAYERS = (("fc6", 8192, 4096), ("fc7", 4096, 4096), ("fc8", 4096, 487))

FEATURE_LAYERS = ("conv5b", "pool5", "fc6", "fc7", "fc8", "prob")

MEAN_PIXEL = 101.2  # fallback scalar mean when no mean cube is provided
RESIZE_HW = (128, 171)  # the VIDEO_DATA resize before the crop
CROP = 112
# the layout the tower runs in (chip_smoke.py times it against NCDHW)
MEMORY_FORMAT = torch.channels_last_3d


def init_params(generator: Optional[torch.Generator] = None, *,
                device=None) -> dict:
    """Random init per the prototxt fillers (gaussian 0.01 conv / 0.005 fc,
    zero biases), drawn on the CPU from `generator`, on `device` (None =
    the card)."""
    dev = resolve_device(device)
    params = {}
    in_ch = 3
    for name, out_ch in CONV_LAYERS:
        params[f"{name}_w"] = 0.01 * torch.randn((out_ch, in_ch, 3, 3, 3),
                                                 generator=generator)
        params[f"{name}_b"] = torch.zeros(out_ch)
        in_ch = out_ch
    for name, d_in, d_out in FC_LAYERS:
        params[f"{name}_w"] = 0.005 * torch.randn((d_out, d_in),
                                                  generator=generator)
        params[f"{name}_b"] = torch.zeros(d_out)
    return {k: v.to(dev) for k, v in params.items()}


def apply(params: dict, clips: torch.Tensor, *,
          feature_layer: str = "conv5b", compute_dtype=None) -> torch.Tensor:
    """clips [N, 3, 16, 112, 112] (mean-subtracted) -> features in f32.

    'conv5b' returns [N, 512, 2, 7, 7]; 'pool5' [N, 512, 1, 4, 4]; 'fc6' /
    'fc7' [N, 4096]; 'fc8' the 487 logits; 'prob' their softmax.
    """
    if feature_layer not in FEATURE_LAYERS:
        raise ValueError(f"feature_layer must be one of {FEATURE_LAYERS}")
    if compute_dtype is None:
        with tf32_off():
            return _apply(params, clips, feature_layer, None)
    return _apply(params, clips, feature_layer, compute_dtype)


def _apply(params: dict, clips: torch.Tensor, feature_layer: str,
           compute_dtype) -> torch.Tensor:
    x = clips
    for name, _ in CONV_LAYERS:
        x = torch.relu_(conv3d(x, params[f"{name}_w"], params[f"{name}_b"],
                               compute_dtype=compute_dtype,
                               out_dtype=compute_dtype))
        if name == "conv5b" and feature_layer == "conv5b":
            return x.float()
        if name in POOLS and name != "conv5b":
            x = max_pool3d(x, *POOLS[name])
    # pool5: SAME takes 2x7x7 to 1x4x4, like Caffe's ceil-mode pooling
    x = max_pool3d(x, *POOLS["conv5b"])
    if feature_layer == "pool5":
        return x.float()
    # flattened in the JAX package's (d, h, w, c) order, so its fc6 weights
    # apply as they are (Caffe flattens (c, d, h, w))
    x = x.permute(0, 2, 3, 4, 1).reshape(x.shape[0], -1)
    for name, _, _ in FC_LAYERS:
        x = linear(x, params[f"{name}_w"].t(), params[f"{name}_b"],
                   compute_dtype=compute_dtype, out_dtype=compute_dtype)
        if name != "fc8":
            x = torch.relu(x)
        if feature_layer == name:
            return x.float()
    return torch.softmax(x.float(), dim=-1)  # 'prob'


def conv5b_to_rgp(features: torch.Tensor) -> torch.Tensor:
    """[N, 512, 2, 7, 7] NCDHW -> [N, 1024, 7, 7] with the blob's
    channel-major (c * 2 + d) fold (`models/gaze_rnn.py:497` of the
    reference)."""
    return features.reshape(features.shape[0], 1024, 7, 7)


# ------------------------------------------------------------ preprocessing

def preprocess_frames(frames: torch.Tensor, mean_cube=None,
                      bgr: bool = False) -> torch.Tensor:
    """[N, 16, H, W, 3] pixels (0..255, any real or integer dtype) -> the
    network input [N, 3, 16, 112, 112] f32 in `MEMORY_FORMAT`.

    Protocol (VIDEO_DATA layer): resize to 128x171 (bilinear, antialiased
    when it shrinks, as `jax.image.resize` does), center-crop 112x112,
    subtract the mean cube, given channels-last as in the JAX package
    ([16, 112, 112, 3] or anything that broadcasts against
    [N, 16, 112, 112, 3]), or the scalar MEAN_PIXEL. bgr=True reorders RGB
    input for Caffe's BGR weights. Frames already at 128x171 (uint8 on the
    wire) are cropped before they are widened to f32.
    """
    n, t, h, w, c = frames.shape
    x = frames.flip(-1) if bgr else frames
    if (h, w) != RESIZE_HW:
        x = resize_bilinear(x.float().reshape(n * t, h, w, c),
                            RESIZE_HW).reshape(n, t, *RESIZE_HW, c)
    top = (RESIZE_HW[0] - CROP) // 2
    left = (RESIZE_HW[1] - CROP) // 2
    x = x[:, :, top:top + CROP, left:left + CROP].float()
    if mean_cube is None:
        x = x - MEAN_PIXEL
    else:
        x = x - torch.as_tensor(mean_cube, dtype=torch.float32,
                                device=x.device)
    # the permuted view of a contiguous NDHWC tensor is channels-last-3d
    return x.permute(0, 4, 1, 2, 3).contiguous(memory_format=MEMORY_FORMAT)


def fold_bgr_into_params(params: dict, mean_cube=None):
    """Reverse conv1a's in-channel axis so BGR-trained weights (Caffe
    Sports-1M) take RGB frames and give the activations the original
    weights give BGR-swapped frames. The fused pipeline feeds decoded RGB
    with no per-frame swap, so Caffe weights go through this once at load
    time. A Caffe mean cube is BGR; pass it to get the RGB cube (channel
    reverse). Returns `folded_params`, or `(folded_params,
    folded_mean_cube)` when a cube is given."""
    out = dict(params)
    out["conv1a_w"] = params["conv1a_w"].flip(1)  # [out, in=3, kd, kh, kw]
    if mean_cube is None:
        return out
    return out, torch.as_tensor(np.asarray(mean_cube)).flip(-1)


def clip_windows(num_frames: int, window: int = 16) -> list[int]:
    """Non-overlapping window start indices (range(0, num_frames, 16) in
    the reference's extractor)."""
    return list(range(0, num_frames, window))


# -------------------------------------------------------- weight ingestion

def params_from_caffe_arrays(arrays: dict) -> dict:
    """Caffe-layout weights -> this model's dict of f32 CPU tensors. Caffe
    conv blobs [out, in, kd, kh, kw] and fc blobs [out, in] are already the
    port's layouts. Accepts a dict keyed by layer name (conv1a, ..., fc8,
    or the prototxt's fc6-1 ...) with 'w'/'b' entries or (w, b) tuples."""
    params = {}
    for name, _ in CONV_LAYERS:
        w, b = _get_wb(arrays, name)
        if w.ndim != 5:
            raise ValueError(f"{name}: expected 5-D conv blob, got {w.shape}")
        params[f"{name}_w"], params[f"{name}_b"] = _tensor(w), _tensor(b)
    for name, _, _ in FC_LAYERS:
        key = f"{name}-1" if name not in arrays and f"{name}-1" in arrays \
            else name
        w, b = _get_wb(arrays, key)
        if w.ndim != 2:
            raise ValueError(f"{name}: expected 2-D fc blob, got {w.shape}")
        params[f"{name}_w"], params[f"{name}_b"] = _tensor(w), _tensor(b)
    return params


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _get_wb(arrays: dict, name: str):
    entry = arrays[name]
    if isinstance(entry, dict):
        return np.asarray(entry["w"]), np.asarray(entry["b"])
    w, b = entry
    return np.asarray(w), np.asarray(b)
