"""Kernel M1: the dense layers' bf16 products with f32 sums on the tensor
cores, the wrappers `ops/layers.matmul_f32` calls in bf16 on the card, and
their plain versions.

Replaces no Pallas kernel: the JAX package leaves these products to XLA.
The port multiplied f32 copies of the bf16-rounded operands on the CUDA
cores (TF32 off), at about the card's f32 peak: 8.4 ms of the cascade's
train step. The kernel (`csrc/gemm_bf16.cu`) multiplies the bf16 operands
on the tensor cores and sums each 64-deep block of the reduction there from
zero, then adds the blocks in f32 with round-to-nearest adds: a tensor-core
chain over the whole reduction, as cuBLAS's bf16 GEMM with an f32 result
runs it, truncates as it sums (24x an f32 GEMM's error at K = 7,203).

Three uses, all with operands padded by the caller to 8 elements a row (16
bytes, as TMA needs): `forward` a [M, Kp] @ b [Kp, Np]; `input_grad`, the
three bf16 terms [M, 3, Np] of an f32 cotangent (`layers.split_bf16`)
times b^T, summed over the terms in the reduction, smallest first; and
`weight_grad`, a^T times the terms, the same. Each returns the f32 sums,
unrounded, cut to the real columns.

Bound on an H100 SXM (989 TFLOP/s bf16): operations, for the cascade's
products (fc1's forward 81 GFLOP: 82 us against 89 MB, 27 us).

On a CUDA tensor the wrappers launch the kernel or raise (no fallback); on
a CPU tensor they run the plain versions, which multiply the same bf16
values in f32 (exact products) and sum the terms smallest first.
`launches` counts the kernel's launches; each adds the layer's contraction
(2 x rows x columns x reduction, a gradient's three terms once) to an open
FLOP counter (`utils/mfu.add_kernel_flops`).
"""

from __future__ import annotations

import threading

import torch

from ...utils import mfu
from . import build

launches = 0
_count_lock = threading.Lock()

# csrc/gemm_bf16.cu's tile: C rows and columns a CTA owns, and the depth of
# one block of the reduction
TILE = 128
BLOCK = 64
SMS = 132
# the card's CTAs at once (one a SM) times two: fewer tiles than this split
# the reduction over grid.z
SLOTS = 2 * SMS


def _splits(mo: int, no: int, blocks: int) -> int:
    """Slices of the reduction's `blocks` blocks over grid.z, so that the
    tiles of an [mo, no] result fill the card; at most one slice per four
    blocks."""
    tiles = -(-mo // TILE) * -(-no // TILE)
    return max(1, min(-(-SLOTS // tiles), blocks // 4)) if tiles < SMS else 1


def _operand(x: torch.Tensor, trans: int, seg: int) -> tuple:
    """The kernel's view of a bf16 operand [outer, inner] or [outer,
    planes, inner]: pointer, dims (inner, planes, outer), element strides
    (plane, outer), trans, seg."""
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError("gemm_bf16 takes contiguous bf16 operands, got "
                         f"{x.dtype} of strides {x.stride()}")
    outer, inner = x.shape[0], x.shape[-1]
    planes = x.shape[1] if x.dim() == 3 else 1
    if inner % 8:
        raise ValueError(f"gemm_bf16 takes rows of a multiple of 8 "
                         f"elements, got {inner}")
    return (x.data_ptr(), inner, planes, outer, inner, planes * inner, trans,
            seg)


def _launch(a: tuple, b: tuple, mo: int, no: int, r: int, segs: int,
            device: torch.device) -> torch.Tensor:
    global launches
    splits = _splits(mo, no, segs * -(-r // BLOCK))
    out = torch.empty((splits, mo, no), dtype=torch.float32, device=device)
    build.launch("gemm_bf16", device, *a, *b, out.data_ptr(), mo, no, no, r,
                 segs, splits)
    with _count_lock:
        launches += 1
    # the layer's contraction, as FlopCounterMode counts an mm: a gradient
    # over the cotangent's three terms counts once
    mfu.add_kernel_flops("gemm_bf16", 2 * mo * no * r)
    total = out[0]
    for s in range(1, splits):
        total = total + out[s]
    return total


def forward_plain(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """a [M, Kp] @ b [Kp, Np] (bf16) in f32, the first n columns."""
    return (a.float() @ b.float())[:, :n]


def input_grad_plain(terms: torch.Tensor, b: torch.Tensor,
                     k: int) -> torch.Tensor:
    """sum over the terms [M, 3, Np] of term @ b [Kp, Np]^T in f32,
    smallest first, the first k columns."""
    p = [t.float() @ b.float().t() for t in terms.unbind(1)]
    return ((p[2] + p[1]) + p[0])[:, :k]


def weight_grad_plain(a: torch.Tensor, terms: torch.Tensor, k: int,
                      n: int) -> torch.Tensor:
    """sum over the terms [M, 3, Np] of a [M, Kp]^T @ term in f32, smallest
    first, the first k rows and n columns."""
    p = [a.float().t() @ t.float() for t in terms.unbind(1)]
    return ((p[2] + p[1]) + p[0])[:k, :n]


def forward(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """a [M, Kp] @ b [Kp, Np], both bf16: [M, n] f32."""
    if not a.is_cuda:
        return forward_plain(a, b, n)
    device = build.same_device("gemm_bf16", a, b)
    m, kp = a.shape
    return _launch(_operand(a, 0, 0), _operand(b, 1, 0), m, n, kp, 1,
                   device)


def input_grad(terms: torch.Tensor, b: torch.Tensor, k: int) -> torch.Tensor:
    """The terms [M, 3, Np] of an f32 cotangent times b [Kp, Np]^T, summed:
    [M, k] f32."""
    if not terms.is_cuda:
        return input_grad_plain(terms, b, k)
    device = build.same_device("gemm_bf16", terms, b)
    m, _, np_ = terms.shape
    return _launch(_operand(terms, 0, 1), _operand(b, 0, 0), m, k, np_, 3,
                   device)


def weight_grad(a: torch.Tensor, terms: torch.Tensor, k: int,
                n: int) -> torch.Tensor:
    """a [M, Kp]^T times the terms [M, 3, Np] of an f32 cotangent, summed:
    [k, n] f32."""
    if not a.is_cuda:
        return weight_grad_plain(a, terms, k, n)
    device = build.same_device("gemm_bf16", a, terms)
    m = a.shape[0]
    return _launch(_operand(a, 1, 0), _operand(terms, 1, 1), k, n, m, 3,
                   device)
