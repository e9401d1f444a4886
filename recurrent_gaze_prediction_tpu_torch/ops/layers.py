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
from .kernels import gemm


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
    """2-D convolution, NHWC x HWIO -> NHWC. SAME pads that are equal on
    both sides (an odd kernel at stride 1) go to the library's conv, which
    pads as it reads: no padded copy of the input, and no slice of its
    gradient; unequal ones (TF/XLA's extra pad at the end) `F.pad`."""
    xc = _cast(x, compute_dtype).permute(0, 3, 1, 2)
    w = _cast(kernel, compute_dtype).permute(3, 2, 0, 1)
    pad = (0, 0)
    if padding == "SAME":
        ph = _same_pads(xc.shape[2], w.shape[2], stride)
        pw = _same_pads(xc.shape[3], w.shape[3], stride)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            pad = (ph[0], pw[0])
        else:
            xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
    elif padding != "VALID":
        raise ValueError(f"padding must be SAME|VALID, got {padding!r}")
    out = F.conv2d(xc, w, stride=stride, padding=pad).permute(0, 2, 3, 1)
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


def _transpose_crop(k: int, s: int, padding: str) -> Optional[int]:
    """What `lax.conv_transpose` cuts from each end of the full transposed
    conv ((size - 1) * s + k) along an axis of kernel size k, where it cuts
    the same from both ends and pads nothing; else None."""
    pad_a, pad_b = _transpose_pads(k, s, padding)
    return k - 1 - pad_a if pad_a == pad_b <= k - 1 else None


class _TransposeConv(torch.autograd.Function):
    """`F.conv_transpose2d(x, w, stride, padding=crop)` whose backward
    hands cuDNN the cotangent of the uncropped output, zero-extended to a
    multiple of the stride: on the cascade's 11x11 stride-7 upsample
    cuDNN's heuristic takes the input gradient of the cropped 49x49 map to
    a CUDA-core kernel (`precomputed_convolve_sgemm`, 6.8 ms at B=28,
    T=42), and that of the 56x56 map to a tensor-core one (0.53 ms). The
    same products, zeros added: the gradients are the library's, summed in
    another order."""

    @staticmethod
    def forward(ctx, x, w, stride, crop):
        ctx.save_for_backward(x, w)
        ctx.geometry = (stride, crop)
        return F.conv_transpose2d(x, w, stride=stride, padding=crop)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        s, crop = ctx.geometry
        dx = dw = None
        if ctx.needs_input_grad[0]:
            full = [-(-((x.shape[i] - 1) * s + w.shape[i]) // s) * s
                    for i in (2, 3)]
            gf = g.new_zeros((g.shape[0], *full, g.shape[1])).permute(
                0, 3, 1, 2)
            gf[:, :, crop[0]:crop[0] + g.shape[2],
               crop[1]:crop[1] + g.shape[3]] = g
            dx = F.conv2d(gf, w, stride=s)
        if ctx.needs_input_grad[1]:
            dw = torch.ops.aten.convolution_backward(
                g, x, w, None, [s, s], list(crop), [1, 1], True, [0, 0], 1,
                [False, True, False])[1]
        return dx, dw, None, None


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
    Where JAX cuts the same from both ends of each axis (every transposed
    conv of the port), the conv crops as it writes (`_TransposeConv`).
    """
    xc = _cast(x, compute_dtype).permute(0, 3, 1, 2)
    w = _cast(kernel, compute_dtype).flip(0, 1).permute(2, 3, 0, 1)
    crops = [_transpose_crop(k, stride, padding) for k in w.shape[2:]]
    if None not in crops:
        out = _TransposeConv.apply(xc, w, stride, tuple(crops))
        return _cast(out.permute(0, 2, 3, 1),
                     out_dtype if out_dtype is not None else torch.float32)
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


# bf16 elements in 16 bytes: TMA (kernel M1) reads rows that start on 16
# bytes, so the operands of `_TensorCoreMatmul` are zero-padded to it (an
# odd K, as fc1's 7,203, would not be)
_ALIGN = 8


def _padded(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """x [r, c] in bf16 in the top-left corner of a zero [rows, cols]."""
    if tuple(x.shape) == (rows, cols):
        return x.to(torch.bfloat16).contiguous()
    out = x.new_zeros((rows, cols), dtype=torch.bfloat16)
    out[:x.shape[0], :x.shape[1]] = x
    return out


def _up(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def split_bf16(g: torch.Tensor, cols: int) -> torch.Tensor:
    """An f32 matrix g [M, N] as three bf16 terms, hi = bf16(g), mid =
    bf16(g - hi), lo = bf16(g - hi - mid), in [M, 3, cols] (cols >= N, the
    columns past N zero). Each residual is exact in f32 and bf16 has f32's
    exponent range, so hi + mid + lo == g for every f32 whose lo stays
    normal (3 x 8 significant bits = 24)."""
    m, n = g.shape
    terms = (g.new_empty if cols == n else g.new_zeros)(
        (m, 3, cols), dtype=torch.bfloat16)
    terms[:, 0, :n] = g
    rest = g - terms[:, 0, :n]
    terms[:, 1, :n] = rest
    rest -= terms[:, 1, :n]
    terms[:, 2, :n] = rest
    return terms


class _TensorCoreMatmul(torch.autograd.Function):
    """a [M, K] @ b [K, N] with both operands rounded to bf16 and f32 sums,
    forward and backward, through kernel M1 (`ops/kernels/gemm.py`).

    The forward multiplies the rounded operands. The backward's cotangent g
    is f32 and unrounded, as in `jnp.dot`'s transpose (an f32 cotangent
    times the bf16 operand, the result rounded to the operand's dtype): g
    is split exactly into three bf16 terms (`split_bf16`), and each
    gradient is one product whose reduction runs over the three terms,
    smallest first, with f32 sums; it is then rounded to bf16 and cast to
    the operand's dtype, as `_cast(.., bf16).float()`'s autograd does.
    Saves the bf16 operands (zero-padded to `_ALIGN`), not f32 copies."""

    @staticmethod
    def forward(ctx, a, b):
        (m, k), n = a.shape, b.shape[1]
        a16, b16 = _padded(a, m, _up(k)), _padded(b, _up(k), _up(n))
        ctx.save_for_backward(a16, b16)
        ctx.dims = (k, n)
        ctx.dtypes = (a.dtype, b.dtype)
        return gemm.forward(a16, b16, n)

    @staticmethod
    def backward(ctx, g):
        a16, b16 = ctx.saved_tensors
        k, n = ctx.dims
        terms = split_bf16(g, b16.shape[1])
        da = db = None
        if ctx.needs_input_grad[0]:
            da = gemm.input_grad(terms, b16, k).to(torch.bfloat16).to(
                ctx.dtypes[0])
        if ctx.needs_input_grad[1]:
            db = gemm.weight_grad(a16, terms, k, n).to(torch.bfloat16).to(
                ctx.dtypes[1])
        return da, db


def matmul_f32(a: torch.Tensor, b: torch.Tensor,
               compute_dtype=None) -> torch.Tensor:
    """a @ b with operands rounded to `compute_dtype` and products summed
    in f32 (`jnp.dot(..., preferred_element_type=f32)`); returns f32. On
    the card in bf16 the products run on the tensor cores, forward and
    backward (`_TensorCoreMatmul`); elsewhere both operands are cast back
    to f32 and multiplied there."""
    if a.is_cuda and compute_dtype == torch.bfloat16 and b.dim() == 2:
        out = _TensorCoreMatmul.apply(a.reshape(-1, a.shape[-1]), b)
        return out.reshape(*a.shape[:-1], b.shape[1])
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
