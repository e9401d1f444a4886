"""Weights across the two packages.

`params_from_jax(tree)` takes the JAX package's parameters as numpy arrays,
nested (`{"cell": {"W_z": ...}}`) or flat with the `"a/b/c"` keys of its
`serving/export.py::flatten_params` (a bundle's params.npz), and returns
the port's state dict (`"cell.W_z"`). `params_to_jax(model)` is its
inverse, with the same names and shapes, so a bundle written by either
package loads in the other's reader. `opt_state_from_jax(state)` carries an
optax state's moments and update count over, so both packages can train on
from the same point. `c3d_params_from_jax` / `c3d_params_to_jax` do the
same for the C3D tower's weights, whose layouts differ between the two,
and `qparams_from_jax` / `qparams_to_jax` for the int8 tower's
(`models/quant.py`; a bundle's `qparams_int8.npz`), bit for bit.
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


def jax_name(name: str) -> str:
    """The port's parameter name ("cell.W_z") -> the JAX package's flat
    name ("cell/W_z")."""
    return name.replace(".", _SEP)


def opt_state_from_jax(opt_state) -> dict:
    """An optax state of the JAX package's optimizer (`build_optimizer`:
    clip + adam | rmsprop | sgd, optionally inside `multi_transform`), with
    numpy leaves and its namedtuples kept, -> the port's `Optimizer` state:
    {"count": int, "mu"/"nu"/"trace": the port's state dict of moments}."""
    out: dict = {}

    def walk(node) -> None:
        if hasattr(node, "_fields"):  # an optax state namedtuple
            for field in node._fields:
                value = getattr(node, field)
                if field == "count":
                    out["count"] = int(np.asarray(value))
                elif field in ("mu", "nu", "trace"):
                    out[field] = params_from_jax(value)
                else:
                    walk(value)
        elif isinstance(node, Mapping):
            for value in node.values():
                walk(value)
        elif isinstance(node, (tuple, list)):
            for value in node:
                walk(value)

    walk(opt_state)
    return out


def params_to_jax(model: nn.Module) -> dict:
    """The port's parameters -> the JAX package's nested numpy tree."""
    flat = {name.replace(".", _SEP): t.detach().float().cpu().numpy()
            for name, t in model.state_dict().items()}
    return unflatten_params(flat)


# C3D weights: the JAX package holds convs as DHWIO [kd, kh, kw, in, out]
# and fc as [in, out]; the port as [out, in, kd, kh, kw] and [out, in].
_C3D_TO_PORT = {5: (4, 3, 0, 1, 2), 2: (1, 0), 1: (0,)}
_C3D_TO_JAX = {5: (2, 3, 4, 1, 0), 2: (1, 0), 1: (0,)}


def c3d_params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """The JAX package's C3D weights (`models/c3d.init_params`'s flat
    "conv1a_w" keys, numpy or jax arrays) -> the port's dict of CPU
    tensors."""
    out = {}
    for key, value in tree.items():
        a = np.asarray(value)
        out[key] = _to_tensor(np.transpose(a, _C3D_TO_PORT[a.ndim]))
    return out


def c3d_params_to_jax(params: Mapping[str, torch.Tensor]
                      ) -> dict[str, np.ndarray]:
    """Inverse of `c3d_params_from_jax`: numpy f32 in the JAX layouts."""
    out = {}
    for key, t in params.items():
        a = t.detach().float().cpu().numpy()
        out[key] = np.ascontiguousarray(np.transpose(a, _C3D_TO_JAX[a.ndim]))
    return out


def qparams_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """The JAX package's int8 tower (`models/quant.quantize_c3d`: per conv
    layer `{name}_wq` int8 DHWIO, `{name}_wscale` [Cout], `{name}_b`
    [Cout], `{name}_xscale` a scalar; numpy or jax arrays, flat keys) ->
    the port's qparams on the CPU: `wq` packed into the kernel's [Cout,
    Kpad] rows, `xscale` an f32 0-d tensor."""
    # imported here: the kernels' package imports utils, whose tree module
    # imports this one
    from .ops.kernels.conv3d_int8 import pack_weights

    out = {}
    for key, value in tree.items():
        a = np.asarray(value)
        if key.endswith("_wq"):
            out[key] = torch.from_numpy(pack_weights(
                np.transpose(a.astype(np.int8), (4, 3, 0, 1, 2))))
        elif key.endswith("_xscale"):
            out[key] = torch.tensor(np.float32(a))
        else:
            out[key] = _to_tensor(a)
    return out


def qparams_to_jax(qparams: Mapping[str, torch.Tensor]
                   ) -> dict[str, np.ndarray]:
    """Inverse of `qparams_from_jax`: numpy in the JAX package's layouts
    (DHWIO int8 `wq`, f32 scales and biases, 0-d f32 `xscale`)."""
    from .models.c3d import CONV_LAYERS
    from .ops.kernels.conv3d_int8 import unpack_weights

    # a layer's input channels: the RGB frame's 3, then the layer before's
    # outputs (the packed rows alone do not say, being padded for Cin < 64)
    names = [name for name, _ in CONV_LAYERS]
    cins = {name: 3 if i == 0 else qparams[f"{names[i - 1]}_wscale"].numel()
            for i, name in enumerate(names)}
    out = {}
    for key, t in qparams.items():
        a = t.detach().cpu().numpy()
        if key.endswith("_wq"):
            out[key] = np.ascontiguousarray(np.transpose(
                unpack_weights(a, cins[key[:-3]]), (2, 3, 4, 1, 0)))
        else:
            out[key] = np.asarray(a, np.float32)
    return out
