"""Weights across the two packages.

`params_from_jax(tree)` takes the JAX package's parameters as numpy arrays,
nested (`{"cell": {"W_z": ...}}`) or flat with the `"a/b/c"` keys of its
`serving/export.py::flatten_params` (a bundle's params.npz), and returns
the port's state dict (`"cell.W_z"`). `params_to_jax(model)` is its
inverse, with the same names and shapes, so a bundle written by either
package loads in the other's reader.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

_SEP = "/"


def flatten_params(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts -> {"a/b/c": array}. Dict-of-dicts only, as the
    bundle format requires."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}{_SEP}{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            out.update(flatten_params(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def unflatten_params(flat: Mapping[str, np.ndarray]) -> dict:
    """Inverse of `flatten_params`."""
    root: dict = {}
    for key, value in flat.items():
        *parents, leaf = key.split(_SEP)
        node = root
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return root


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind not in "fiu":   # ml_dtypes.bfloat16 and friends
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a))


def params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """JAX parameters (nested or flat "a/b/c") -> the port's state dict."""
    flat = flatten_params(tree)
    return {key.replace(_SEP, "."): _to_tensor(v) for key, v in flat.items()}


def params_to_jax(model: nn.Module) -> dict:
    """The port's parameters -> the JAX package's nested numpy tree."""
    flat = {name.replace(".", _SEP): t.detach().float().cpu().numpy()
            for name, t in model.state_dict().items()}
    return unflatten_params(flat)
