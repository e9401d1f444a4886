"""Core NN ops on the slice's path: conv / deconv / linear / dropout /
frozen batch norm.

Plain tensor functions with the JAX package's layouts at the interface:
NHWC activations and HWIO kernels (`ops/layers.py` there), so the tests
compare like with like. Inside, each op permutes to PyTorch's NCHW / OIHW.

`compute_dtype` follows JAX's `preferred_element_type=None` rule: with a
compute dtype the conv returns its result IN that dtype (rounded there),
and only then is cast to f32 (or `out_dtype`). `linear` and the decoder's
matmul accumulate in f32 and return f32, as `jnp.dot(...,
preferred_element_type=f32)` does: their operands are rounded to the
compute dtype and multiplied in f32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _cast(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    return x.to(dtype) if dtype is not None and x.dtype != dtype else x


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """TF/XLA SAME padding (extra pad at the end)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, kernel: torch.Tensor, *, stride: int = 1,
           padding: str = "SAME", compute_dtype=None,
           out_dtype=None) -> torch.Tensor:
    """2-D convolution, NHWC x HWIO -> NHWC."""
    xc = _cast(x, compute_dtype).permute(0, 3, 1, 2)
    w = _cast(kernel, compute_dtype).permute(3, 2, 0, 1)
    if padding == "SAME":
        ph = _same_pads(xc.shape[2], w.shape[2], stride)
        pw = _same_pads(xc.shape[3], w.shape[3], stride)
        xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
    elif padding != "VALID":
        raise ValueError(f"padding must be SAME|VALID, got {padding!r}")
    out = F.conv2d(xc, w, stride=stride).permute(0, 2, 3, 1)
    return _cast(out, out_dtype if out_dtype is not None else torch.float32)


def _transpose_pads(k: int, s: int, padding: str) -> tuple[int, int]:
    """`lax.conv_transpose`'s padding of the stride-dilated input."""
    if padding == "SAME":
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    elif padding == "VALID":
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    else:
        raise ValueError(f"padding must be SAME|VALID, got {padding!r}")
    return pad_a, pad_len - pad_a


def conv2d_transpose(x: torch.Tensor, kernel: torch.Tensor, *, stride: int,
                     padding: str = "VALID", compute_dtype=None,
                     out_dtype=None) -> torch.Tensor:
    """Fractionally-strided conv with `lax.conv_transpose` semantics,
    NHWC x HWIO -> NHWC.

    `lax.conv_transpose(transpose_kernel=False)` correlates the dilated
    input with the kernel, i.e. it scatters the SPATIALLY FLIPPED kernel:
    y[o] = sum_i x[i] * flip(K)[o - s*i + (k-1-pad_a)]. PyTorch's
    `conv_transpose2d` scatters its weight unflipped, so the kernel is
    flipped and permuted HWIO -> IOHW, the full output is formed, and the
    window JAX keeps is cut out (zero-extended where JAX pads past it).
    """
    xc = _cast(x, compute_dtype).permute(0, 3, 1, 2)
    w = _cast(kernel, compute_dtype).flip(0, 1).permute(2, 3, 0, 1)
    full = F.conv_transpose2d(xc, w, stride=stride)
    for axis, (size, k) in ((2, (xc.shape[2], w.shape[2])),
                            (3, (xc.shape[3], w.shape[3]))):
        pad_a, pad_b = _transpose_pads(k, stride, padding)
        length = (size - 1) * stride + 1 + pad_a + pad_b - k + 1
        start = k - 1 - pad_a
        if start < 0 or start + length > full.shape[axis]:
            lo, hi = max(-start, 0), max(start + length - full.shape[axis], 0)
            pads = [0, 0, 0, 0]
            pads[(3 - axis) * 2:(3 - axis) * 2 + 2] = [lo, hi]
            full = F.pad(full, pads)
            start += lo
        full = full.narrow(axis, start, length)
    out = full.permute(0, 2, 3, 1)
    return _cast(out, out_dtype if out_dtype is not None else torch.float32)


def matmul_f32(a: torch.Tensor, b: torch.Tensor,
               compute_dtype=None) -> torch.Tensor:
    """a @ b with operands rounded to `compute_dtype` and products summed
    in f32 (`jnp.dot(..., preferred_element_type=f32)`); returns f32."""
    return torch.matmul(_cast(a, compute_dtype).float(),
                        _cast(b, compute_dtype).float())


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None, *, compute_dtype=None,
           out_dtype=None) -> torch.Tensor:
    """x @ w + b with fp32 accumulation (`tf.nn.xw_plus_b`)."""
    out = matmul_f32(x, w, compute_dtype)
    if b is not None:
        out = out + b.float()
    return _cast(out, out_dtype)


def dropout(x: torch.Tensor, rate_keep: float,
            generator: Optional[torch.Generator],
            deterministic: bool) -> torch.Tensor:
    """TF-style dropout: scale kept activations by 1/keep_prob. The
    generator must live on x's device."""
    if deterministic or rate_keep >= 1.0:
        return x
    if generator is None:
        raise ValueError("dropout requires a generator in train mode")
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < rate_keep
    return torch.where(keep, x / rate_keep, 0.0).to(x.dtype)


def frozen_batch_norm(x: torch.Tensor, scale: torch.Tensor,
                      offset: torch.Tensor, eps: float = 1e-3
                      ) -> torch.Tensor:
    """Batch norm in inference mode with untrained statistics (mean=0,
    var=1): y = scale * x / sqrt(1 + eps) + offset, eps 1e-3 as in TF."""
    inv = torch.rsqrt(torch.tensor(1.0 + eps, dtype=x.dtype, device=x.device))
    return x * (scale.to(x.dtype) * inv) + offset.to(x.dtype)
