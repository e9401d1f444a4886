"""Serving bundles: the port's counterpart of the JAX package's
`serving/export.py`.

A bundle is a directory with `manifest.json` (format version, the model
config, the programs) and `params.npz` (weights under flat "a/b/c" keys),
in the JAX package's layout. That package also stores ahead-of-time
programs (`*.jaxexp`); the port skips them when it reads a bundle and never
writes them: `load_bundle` rebuilds the live model from the manifest's
config and loads the weights. A bundle written here lists its programs
under `torch_programs`, so the JAX package's `load_bundle` still reads its
config and weights.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ..bridge import (flatten_params, params_from_jax, params_to_jax,
                      unflatten_params)
from ..config import ModelConfig
from ..models.common import GazeModel

MANIFEST = "manifest.json"
PARAMS = "params.npz"
# the dtype a bundle's predict program takes its frames and features in
WIRE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def save_bundle(path: str, model: GazeModel, *,
                wire_dtype: str = "float32") -> None:
    """Write `model`'s config and weights as a bundle directory.

    `wire_dtype` ("float32" | "bfloat16") is the predict program's input
    dtype: a bfloat16 bundle rounds incoming frames and features to bf16
    and computes in f32 from there, as the JAX package's bundles do."""
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(f"wire_dtype must be float32|bfloat16, got "
                         f"{wire_dtype!r}")
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
    bundle's config and weights."""
    from ..registry import build_model

    manifest = read_manifest(path)
    model = build_model(ModelConfig(**manifest["model"]), device=device)
    with np.load(os.path.join(path, PARAMS)) as data:
        tree = unflatten_params({k: data[k] for k in data.files})
    model.load_state_dict(params_from_jax(tree))
    return model
