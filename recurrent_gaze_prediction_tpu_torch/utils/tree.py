"""Parameter counting, dtype casting and flat summaries: the port's
counterpart of the JAX package's `utils/tree.py`.

Each function takes an `nn.Module` (its `state_dict()`: every tensor a
checkpoint or bundle carries) or a `{name: tensor}` dict such as
`TrainState.params` or a C3D tower's weights.
"""

from __future__ import annotations

from typing import Union

import torch
from torch import nn

from ..bridge import jax_name

Params = Union[nn.Module, dict]


def _tensors(params: Params) -> dict:
    return params.state_dict() if isinstance(params, nn.Module) else params


def param_count(params: Params) -> int:
    """Total number of scalar parameters (reference:
    `models/base.py:300-304`)."""
    return sum(t.numel() for t in _tensors(params).values())


def param_bytes(params: Params) -> int:
    return sum(t.numel() * t.element_size()
               for t in _tensors(params).values())


def cast_floating(params: Params, dtype: torch.dtype) -> dict:
    """A `{name: tensor}` dict with the floating-point tensors cast to
    `dtype` and the integer ones as they are."""
    return {name: t.to(dtype) if t.is_floating_point() else t
            for name, t in _tensors(params).items()}


def describe(params: Params, prefix: str = "") -> str:
    """Human-readable listing of every tensor under its JAX flat name
    ("cell/W_z"): name, shape, dtype, count; then the total."""
    lines = []
    total = 0
    for name, t in _tensors(params).items():
        n = t.numel()
        total += n
        lines.append(f"  {prefix + jax_name(name):60s} "
                     f"{str(tuple(t.shape)):20s} {str(t.dtype):10s} {n}")
    lines.append(f"  TOTAL: {total} parameters")
    return "\n".join(lines)
