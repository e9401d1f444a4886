"""Serving bundles: the port's counterpart of the JAX package's
`serving/export.py`.

A bundle is a directory with `manifest.json` (format version, the model
config, the programs) and `params.npz` (weights under flat "a/b/c" keys),
in the JAX package's layout. That package also stores ahead-of-time
programs (`*.jaxexp`); the port skips them when it reads a bundle and never
writes them: `load_bundle` rebuilds the live model from the manifest's
config and loads the weights, and keeps each program's manifest entry on
the model (`bundle_programs`). A bundle written here lists its programs
under `torch_programs`, so the JAX package's `load_bundle` still reads its
config and weights.

Programs: `predict` (features -> maps), `fused` (raw video -> maps, the
C3D tower in the same program, `fused_predict_fn`) and `fused_int8` (the
same with the int8 tower, `fused_int8_predict_fn`: kernel Q1), all served
over HTTP (`serving/server.py`); and, for the ConvGRU family, `stream`,
the carried-state chunk step, run through `stream_step` /
`initial_stream_state` (the counterparts of the JAX `ServingBundle`
methods of those names). The int8 tower's weights are `qparams_int8.npz`
in the JAX package's layout (`bridge.qparams_to_jax`), so either package's
`fused_int8` bundle serves from the other's reader.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
from typing import Optional

import numpy as np
import torch

from ..bridge import (c3d_params_from_jax, c3d_params_to_jax, flatten_params,
                      params_from_jax, params_to_jax, qparams_from_jax,
                      qparams_to_jax, unflatten_params)
from ..config import ModelConfig
from ..models.common import GazeModel
from ..models.gaze_grcn import GazeGRCN
from ..models.pipeline import make_fused_predict
from ..models.quant import make_int8_c3d_forward
from ..models.streaming import grcn_stream_step
from ..train.profiler import count, span
from .upload import LanePool, stage_to_device

MANIFEST = "manifest.json"
PARAMS = "params.npz"
C3D_PARAMS = "c3d_params.npz"
QPARAMS_INT8 = "qparams_int8.npz"
# the dtype a bundle's predict program takes its frames and features in
WIRE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the dtype the fused program takes its pixels in
VIDEO_DTYPES = ("float32", "uint8")


def save_bundle(path: str, model: GazeModel, *,
                wire_dtype: str = "float32",
                stream_chunk_len: Optional[int] = None,
                c3d_params: Optional[dict] = None,
                num_frames: Optional[int] = None,
                video_hw: tuple[int, int] = (128, 171),
                video_dtype: str = "float32",
                c3d_compute_dtype: str = "bfloat16",
                int8_qparams: Optional[dict] = None) -> None:
    """Write `model`'s config and weights as a bundle directory.

    `wire_dtype` ("float32" | "bfloat16") is the input dtype of the predict
    and stream programs' features: a bfloat16 bundle rounds incoming frames
    and features to bf16 and computes in f32 from there, as the JAX
    package's bundles do. `stream_chunk_len` records the streaming chunk
    step too; like the JAX package, only gaze_grcn (the ConvGRU family with
    the 49x49 decoder) has one.

    `c3d_params` with `num_frames` records the `fused` raw-video program:
    the tower's weights go to `c3d_params.npz` in the JAX package's flat
    layout, and the program takes [B, num_frames, *video_hw, 3] pixels in
    `video_dtype` ("float32" | "uint8"; uint8 is exact for decoded video
    and a quarter of the bytes). `c3d_compute_dtype` ("bfloat16" |
    "float32") is the tower's; a JAX bundle's fused program, which records
    none, runs it in f32.

    `int8_qparams` (from `models.quant.quantize_for_pipeline`) with
    `num_frames` records the `fused_int8` program: the int8 tower's
    weights go to `qparams_int8.npz` in the JAX package's flat layout, and
    the program takes the same pixels as `fused`."""
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(f"wire_dtype must be float32|bfloat16, got "
                         f"{wire_dtype!r}")
    if video_dtype not in VIDEO_DTYPES:
        raise ValueError(f"video_dtype must be float32|uint8, got "
                         f"{video_dtype!r}")
    if c3d_compute_dtype not in WIRE_DTYPES:
        raise ValueError(f"c3d_compute_dtype must be bfloat16|float32, got "
                         f"{c3d_compute_dtype!r}")
    if stream_chunk_len is not None and not isinstance(model, GazeGRCN):
        raise ValueError(f"the stream program exists only for gaze_grcn, "
                         f"got {model.cfg.name}; gaze_lstm streams through "
                         f"models.streaming.lstm_stream_step")
    os.makedirs(path, exist_ok=True)
    cfg = model.cfg
    manifest = {
        "format_version": 1,
        "model": dataclasses.asdict(cfg),
        "programs": {},
        "torch_programs": {"predict": {
            "inputs": f"params, frames [B,T,H,W,3] {wire_dtype} in [0,1], "
                      f"c3d [B,T,1024,7,7] {wire_dtype}",
            "t": cfg.n_lstm_steps,
            "wire_dtype": wire_dtype,
        }},
    }
    if stream_chunk_len is not None:
        manifest["torch_programs"]["stream"] = {
            "inputs": f"params, state [B,7,7,U] f32, chunk "
                      f"[B,Tc,1024,7,7] {wire_dtype}",
            "chunk_len": int(stream_chunk_len),
            "state_size": cfg.rnn_state_size,
            "wire_dtype": wire_dtype,
        }
    if c3d_params is not None and num_frames is not None:
        manifest["torch_programs"]["fused"] = {
            "inputs": f"c3d_params, params, video [B,F,H,W,3] "
                      f"{video_dtype} 0..255",
            "num_frames": int(num_frames),
            "video_hw": list(video_hw),
            "video_dtype": video_dtype,
            "compute_dtype": c3d_compute_dtype,
        }
        np.savez(os.path.join(path, C3D_PARAMS),
                 **c3d_params_to_jax(c3d_params))
    if int8_qparams is not None and num_frames is not None:
        manifest["torch_programs"]["fused_int8"] = {
            "inputs": f"qparams_int8, params, video [B,F,H,W,3] "
                      f"{video_dtype} 0..255",
            "num_frames": int(num_frames),
            "video_hw": list(video_hw),
            "video_dtype": video_dtype,
        }
        np.savez(os.path.join(path, QPARAMS_INT8),
                 **qparams_to_jax(int8_qparams))
    np.savez(os.path.join(path, PARAMS),
             **flatten_params(params_to_jax(model)))
    with open(os.path.join(path, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
        f.write("\n")


def read_manifest(path: str) -> dict:
    with open(os.path.join(path, MANIFEST)) as f:
        return json.load(f)


def program_meta(manifest: dict, program: str) -> dict:
    """A program's manifest entry, from either package's bundle."""
    return (manifest.get("programs", {}).get(program)
            or manifest.get("torch_programs", {}).get(program) or {})


def load_bundle(path: str, device=None) -> GazeModel:
    """The live model of a bundle on `device` (None = the card), with the
    bundle's config and weights; the tower's weights, where the bundle has
    them, as `model.bundle_c3d_params` and `model.bundle_qparams_int8`."""
    from ..registry import build_model

    manifest = read_manifest(path)
    model = build_model(ModelConfig(**manifest["model"]), device=device)
    with np.load(os.path.join(path, PARAMS)) as data:
        tree = unflatten_params({k: data[k] for k in data.files})
    model.load_state_dict(params_from_jax(tree))
    model.bundle_programs = {
        name: program_meta(manifest, name)
        for name in (*manifest.get("programs", {}),
                     *manifest.get("torch_programs", {}))}
    dev = next(model.parameters()).device
    model.bundle_c3d_params = model.bundle_qparams_int8 = None
    for attr, name, convert in (
            ("bundle_c3d_params", C3D_PARAMS, c3d_params_from_jax),
            ("bundle_qparams_int8", QPARAMS_INT8, qparams_from_jax)):
        if os.path.exists(os.path.join(path, name)):
            with np.load(os.path.join(path, name)) as data:
                weights = convert({k: data[k] for k in data.files})
            # the int8 tower's input scales stay host scalars
            setattr(model, attr, {
                k: v if k.endswith("_xscale") else v.to(dev)
                for k, v in weights.items()})
    return model


def fused_predict_fn(model: GazeModel):
    """The bundle's `fused` program as `fn(video [B,F,H,W,3]) -> maps`:
    pixels in the program's video dtype on any device go to the model's
    device as they are (uint8 stays uint8 until the card widens it), then
    one fused predict with the bundle's tower in its compute dtype (f32,
    TF32 off, for a JAX bundle). `model` comes from `load_bundle`."""
    meta = getattr(model, "bundle_programs", {}).get("fused")
    if meta is None or model.bundle_c3d_params is None:
        raise KeyError("bundle has no fused program (saved without "
                       "c3d_params/num_frames)")
    cdt = meta.get("compute_dtype", "float32")
    fn = make_fused_predict(
        model, num_frames=int(meta["num_frames"]),
        compute_dtype=None if cdt == "float32" else WIRE_DTYPES[cdt])
    return _served_video(fn, model.bundle_c3d_params,
                         next(model.parameters()).device)


def fused_int8_predict_fn(model: GazeModel):
    """The bundle's `fused_int8` program as `fn(video [B,F,H,W,3]) ->
    maps`: `fused_predict_fn` with the int8 C3D tower (kernel Q1 on the
    card) in place of the library tower. `model` comes from
    `load_bundle`."""
    meta = getattr(model, "bundle_programs", {}).get("fused_int8")
    if meta is None or model.bundle_qparams_int8 is None:
        raise KeyError("bundle has no fused_int8 program (export with "
                       "--int8)")
    qparams = model.bundle_qparams_int8
    fn = make_fused_predict(model, num_frames=int(meta["num_frames"]),
                            compute_dtype=None,
                            c3d_forward=make_int8_c3d_forward(qparams))
    return _served_video(fn, qparams, next(model.parameters()).device)


def _served_video(fn, tower, dev: torch.device):
    """`fn(tower, video)` served: each call uploads its video through the
    program's upload lanes (`serving.upload`; directly on a CPU model or
    for a video already on the card) and counts the bytes staged under
    `serve.predict` as `upload.staged_bytes`."""
    pool = LanePool(dev)
    calls = itertools.count()

    def predict(video) -> torch.Tensor:
        with span("serve.predict", request=next(calls)):
            with span("serve.upload"):
                video, staged = stage_to_device(video, dev, pool)
            count("upload.staged_bytes", staged)
            return fn(tower, video)

    return predict


def stream_step(model: GazeModel, state, c3d_chunk
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The bundle's carried-state chunk step -> (new_state, chunk logits
    [B,Tc,49,49]). `model` comes from `load_bundle`. The chunk
    [B,Tc,1024,7,7] is rounded to the program's wire dtype; `state` is f32
    ALWAYS (feed back what the previous step returned, or
    `initial_stream_state`), and is not rounded."""
    meta = getattr(model, "bundle_programs", {}).get("stream")
    if meta is None:
        raise KeyError("bundle has no stream program")
    wire = WIRE_DTYPES[meta.get("wire_dtype", "float32")]
    dev = next(model.parameters()).device
    chunk = torch.as_tensor(c3d_chunk).to(dev).to(wire).float()
    state = torch.as_tensor(state).to(dev, torch.float32)
    return grcn_stream_step(model, state, chunk)


def initial_stream_state(model: GazeModel, batch: int) -> torch.Tensor:
    """The stream program's zero state [B,7,7,U] f32 on the model's
    device."""
    return torch.zeros((batch, 7, 7, model.cfg.rnn_state_size),
                       dtype=torch.float32,
                       device=next(model.parameters()).device)
