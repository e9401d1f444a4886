"""Rounding to a lower precision than the configuration states: the
controls that `correct` has to refuse."""

from __future__ import annotations

import torch


def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`t` rounded to a float8 format under a per-tensor scale that takes
    its largest magnitude to the format's largest, as fp8 training scales
    its tensors."""
    scale = t.abs().amax().clamp_min(1e-30) / torch.finfo(dtype).max
    return (t / scale).to(dtype).to(t.dtype) * scale


class _RoundFP8(torch.autograd.Function):
    """An operand of a contraction in fp8 training: forward in e4m3, its
    gradient in e5m2 (the usual recipe: e4m3's precision for values, e5m2's
    range for gradients)."""

    @staticmethod
    def forward(ctx, t):
        return _round(t.detach(), torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2)


def fp8(t: torch.Tensor) -> torch.Tensor:
    return _RoundFP8.apply(t)
