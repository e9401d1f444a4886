"""Parameter initializers matching the reference's per-layer init recipes.

The port's counterpart of the JAX package's `ops/initializers.py`, drawing
from an explicit `torch.Generator` (CPU tensors; callers move the finished
module to its device). The same seed gives other numbers than `jax.random`,
so the tests carry weights across with `bridge.py`.

Fan computation follows TF's `_compute_fans`: receptive_field = prod of all
dims except the last two; fan_in = shape[-2] * rf, fan_out = shape[-1] * rf.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def _fans(shape: Sequence[int]) -> tuple[float, float]:
    if len(shape) < 1:
        return 1.0, 1.0
    if len(shape) == 1:
        return float(shape[0]), float(shape[0])
    receptive = math.prod(shape[:-2])
    return float(shape[-2] * receptive), float(shape[-1] * receptive)


def _uniform(shape: Sequence[int], lo: float, hi: float,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    return torch.empty(tuple(shape)).uniform_(lo, hi, generator=generator)


def xavier_uniform(shape: Sequence[int], *,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """TF `xavier_initializer(_conv2d)(uniform=True)` equivalent."""
    fan_in, fan_out = _fans(shape)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return _uniform(shape, -limit, limit, generator)


def truncated_normal(shape: Sequence[int], stddev: float = 1e-4, *,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """TF `tf.truncated_normal`: normal truncated at 2 sigma, drawn by
    inverting the normal CDF on a uniform sample of [Phi(-2), Phi(2)]."""
    edge = math.erf(2.0 / math.sqrt(2.0))
    u = _uniform(shape, -edge, edge, generator)
    return stddev * math.sqrt(2.0) * torch.erfinv(u)


def uniform_scale(shape: Sequence[int], scale: float = 0.1, *,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """`tf.random_uniform([-scale, scale])` used for projection weights."""
    return _uniform(shape, -scale, scale, generator)
