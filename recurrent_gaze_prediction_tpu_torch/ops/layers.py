"""Core NN ops on the port's paths: conv / deconv / 2-D and 3-D pools /
3-D conv / linear / maxout / dropout / frozen batch norm.

Plain tensor functions with the JAX package's layouts at the interface:
NHWC activations and HWIO kernels (`ops/layers.py` there), so the tests
compare like with like. Inside, each op permutes to PyTorch's NCHW / OIHW.

`compute_dtype` follows JAX's `preferred_element_type=None` rule: with a
compute dtype the conv returns its result IN that dtype (rounded there),
and only then is cast to f32 (or `out_dtype`). `linear` and the decoder's
matmul accumulate in f32 and return f32, as `jnp.dot(...,
preferred_element_type=f32)` does: their operands are rounded to the
compute dtype and multiplied in f32.

`linear` with a weight split over the "model" axis (`parallel.
shard_params`) is column-parallel: the rank's product with its columns,
gathered over the model group, then the whole bias.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .collectives import gather_columns, shard_of, sum_cotangent


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


def _pool_pads(x: torch.Tensor, window: tuple[int, int],
               stride: tuple[int, int], padding: str) -> list[int]:
    """F.pad's list for an NCHW tensor under TF/XLA SAME (the extra pad at
    the high end) or VALID."""
    if padding == "VALID":
        return [0, 0, 0, 0]
    if padding != "SAME":
        raise ValueError(f"padding must be SAME|VALID, got {padding!r}")
    ph = _same_pads(x.shape[2], window[0], stride[0])
    pw = _same_pads(x.shape[3], window[1], stride[1])
    return [pw[0], pw[1], ph[0], ph[1]]


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def max_pool2d(x: torch.Tensor, window, stride,
               padding: str = "SAME") -> torch.Tensor:
    """2-D max pool over NHWC with the JAX package's `reduce_window`
    semantics: SAME pads with -inf, the extra pad on the high side (an
    explicit pad, since `F.max_pool2d(padding=)` pads both sides
    equally)."""
    window, stride = _pair(window), _pair(stride)
    xc = x.permute(0, 3, 1, 2)
    pads = _pool_pads(xc, window, stride, padding)
    if any(pads):
        xc = F.pad(xc, pads, value=float("-inf"))
    return F.max_pool2d(xc, window, stride).permute(0, 2, 3, 1)


def avg_pool2d(x: torch.Tensor, window, stride,
               padding: str = "VALID") -> torch.Tensor:
    """2-D average pool over NHWC; under SAME each window is divided by the
    count of its real (unpadded) elements, as in the JAX package."""
    window, stride = _pair(window), _pair(stride)
    xc = x.permute(0, 3, 1, 2)
    pads = _pool_pads(xc, window, stride, padding)
    if not any(pads):
        return F.avg_pool2d(xc, window, stride).permute(0, 2, 3, 1)
    summed = F.avg_pool2d(F.pad(xc, pads), window, stride,
                          divisor_override=1)
    ones = F.pad(torch.ones_like(xc[:1, :1]), pads)
    counts = F.avg_pool2d(ones, window, stride, divisor_override=1)
    return (summed / counts).permute(0, 2, 3, 1)


def _same_pads_3d(x: torch.Tensor, window, stride) -> list[tuple[int, int]]:
    return [_same_pads(size, k, s)
            for size, k, s in zip(x.shape[2:], window, stride)]


def conv3d(x: torch.Tensor, kernel: torch.Tensor,
           bias: Optional[torch.Tensor] = None, *, stride=(1, 1, 1),
           padding: str = "SAME", compute_dtype=None,
           out_dtype=None) -> torch.Tensor:
    """3-D convolution (the C3D tower's conv blocks), NCDHW x OIDHW ->
    NCDHW. Unlike the 2-D ops above, this one keeps PyTorch's layouts at
    the interface: the tower runs in them from its input to conv5b, whose
    [N,512,2,7,7] folds to [N,1024,7,7] by a reshape. The dtype rule is the
    JAX package's `conv3d`: with a compute dtype the result comes out in
    it (accumulated in f32 by the library), then is cast to `out_dtype`
    (f32 when None). The bias, in the compute dtype, is added by the
    library's conv before that rounding (the JAX package adds it after; in
    f32 the two agree, in bf16 they differ by a rounding), which saves a
    pass over the tower's largest tensors. The memory format (NCDHW or
    channels-last-3d) follows the input's."""
    stride = tuple(stride)
    w = _cast(kernel, compute_dtype)
    xc = _cast(x, compute_dtype)
    if padding == "SAME":
        pads = _same_pads_3d(xc, w.shape[2:], stride)
        if any(lo != hi for lo, hi in pads):
            xc = F.pad(xc, [p for lo_hi in reversed(pads) for p in lo_hi])
            pad = 0
        else:
            pad = tuple(lo for lo, _ in pads)
    elif padding == "VALID":
        pad = 0
    else:
        raise ValueError(f"padding must be SAME|VALID, got {padding!r}")
    b = None if bias is None else bias.to(xc.dtype)
    out = F.conv3d(xc, w, b, stride=stride, padding=pad)
    return _cast(out, out_dtype if out_dtype is not None else torch.float32)


def max_pool3d(x: torch.Tensor, window, stride,
               padding: str = "SAME") -> torch.Tensor:
    """3-D max pool over NCDHW (C3D POOLING3D) with the JAX package's
    `reduce_window` semantics: SAME pads with -inf, the extra pad on the
    high side (pool5 takes [2,7,7] to [1,4,4])."""
    window, stride = tuple(window), tuple(stride)
    if padding == "SAME":
        pads = _same_pads_3d(x, window, stride)
        if any(lo or hi for lo, hi in pads):
            x = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi],
                      value=float("-inf"))
    elif padding != "VALID":
        raise ValueError(f"padding must be SAME|VALID, got {padding!r}")
    return F.max_pool3d(x, window, stride)


def resize_bilinear(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """[N, H, W, C] f32 -> [N, h, w, C], `jax.image.resize(method=
    "bilinear")` semantics: half-pixel centers, and an antialiasing
    (triangle) filter widened by the scale when it shrinks an axis, which
    is PyTorch's `antialias=True`."""
    out = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw),
                        mode="bilinear", align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1)


def matmul_f32(a: torch.Tensor, b: torch.Tensor,
               compute_dtype=None) -> torch.Tensor:
    """a @ b with operands rounded to `compute_dtype` and products summed
    in f32 (`jnp.dot(..., preferred_element_type=f32)`); returns f32."""
    return torch.matmul(_cast(a, compute_dtype).float(),
                        _cast(b, compute_dtype).float())


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None, *, compute_dtype=None,
           out_dtype=None) -> torch.Tensor:
    """x @ w + b with fp32 accumulation (`tf.nn.xw_plus_b`). A `w` that
    holds this rank's columns (`ops/collectives.py`) gives the whole
    product: the cotangent of `x` is summed over the model group and the
    columns are gathered (the bias stays whole, as in the JAX package)."""
    shard = shard_of(w)
    if shard is None:
        out = matmul_f32(x, w, compute_dtype)
    else:
        out = gather_columns(matmul_f32(sum_cotangent(x, shard), w,
                                        compute_dtype), shard)
    if b is not None:
        out = out + b.float()
    return _cast(out, out_dtype)


def maxout2(x: torch.Tensor) -> torch.Tensor:
    """Split the last dim in two halves and take their elementwise max
    (`models/saliency_shallownet.py:157-158,178-179`)."""
    a, b = x.chunk(2, dim=-1)
    return torch.maximum(a, b)


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
