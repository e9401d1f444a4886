"""ConvGRU recurrence: the hand-written CUDA kernel's wrapper; what the
cluster-split kernels (B1 here, B2 in `convgru_vjp2.py`, B3 in
`convlstm.py`) share: the packing of their weight slices, their shared
memory reckoning and the rule of which shapes they take; and the plain conv
helpers of the backward modules and of B5 (`convgru_small.py`).

Replaces the TPU kernel `_convgru_seq_kernel` of the JAX package's
`ops/pallas/convgru.py` (`convgru_scan_pallas`, wrapper `convgru_scan`).
The kernel (`csrc/convgru_fwd.cu`) runs the whole recurrence over T in one
launch. Each batch element runs on a thread-block cluster of
`cluster_size(U)` CTAs (8 at U=128); each CTA owns U/C output channels,
keeps its column slices of the weights in shared memory for the whole
sequence, and gathers the full state from its peers through distributed
shared memory; the state convs run on the tensor cores in bf16.

Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s) at T=42, U=128 in bf16:
operations, T*B*49*9*U*3U*2 = 14.6 GFLOP at B=8 (15 us) and 29.1 GFLOP at
B=16 (29 us), against ~43 MB moved at B=16 (13 us). The recurrence is
sequential in T, so a step's latency on one cluster is what the design
works on.

On a CUDA tensor the wrapper launches the kernel or raises (no fallback).
On a CPU tensor it runs the plain version, `ConvGRU.scan_precomputed`,
which the tests and `chip_smoke.py` hold the kernel against.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..cells import ConvGRU
from ..layers import conv2d
from ...utils import mfu
from . import build

# Launches of the CUDA kernel in this process; chip_smoke.py resets it to
# 0 before driving the serving path and reads it after.
launches = 0
_count_lock = threading.Lock()

_DTYPES = {torch.bfloat16: 2, torch.float32: 4}

# The cluster kernels' constants (csrc/cluster_conv.cuh)
MAX_CLUSTER = 8     # CTAs per cluster: the portable maximum
K_GROUPS = 4        # the conv depth's split across warps (bf16; B3: 1)
SMEM_LIMIT = 232448  # shared memory one CTA can have (227 KB)


def cluster_size(units: int) -> int:
    """CTAs per batch element: the largest divisor of U/16 that is at most
    MAX_CLUSTER, so each CTA owns a multiple of 16 channels (U=16 -> 1,
    32 -> 2, 48 -> 3, 128 -> 8)."""
    tiles = units // 16
    return max(c for c in range(1, MAX_CLUSTER + 1) if tiles % c == 0)


def column_slices(kernel: torch.Tensor, clusters: int,
                  groups: int = 1) -> torch.Tensor:
    """[3,3,K,groups*U] -> [C,9,K,groups*Ns] with Ns = U / C: CTA k's
    output columns, the columns [k*Ns, (k+1)*Ns) of each of the `groups`
    blocks of U (z then r for U_zr), taps flattened."""
    k_in, n = kernel.shape[2], kernel.shape[3]
    ns = n // (groups * clusters)
    return (kernel.reshape(9, k_in, groups, clusters, ns)
            .permute(3, 0, 1, 2, 4).reshape(clusters, 9, k_in, groups * ns))


def fragment_order(slices: torch.Tensor) -> torch.Tensor:
    """[C,9,K,N] slices -> the same values in mma.m16n8k16 fragment order
    (`csrc/cluster_conv.cuh`), [C, 9K/16, N/16, 32 lanes, 8]: for k-step s
    (rows 16s..16s+15 of the [9K, N] slice) and column pair q, lane
    l = 4g + c holds B[16s+2c+{0,1}][n], B[16s+2c+8+{0,1}][n] for
    n = 16q+g, then the same for n = 16q+8+g."""
    c, _, k_in, n = slices.shape
    # row 16s + 8*half + 2*c + kp, column 16q + 8*tile + g
    parts = slices.reshape(c, 9 * k_in // 16, 2, 4, 2, n // 16, 2, 8)
    # -> [C, s, q, g, c, tile, half, kp]
    return parts.permute(0, 1, 5, 7, 3, 6, 2, 4).reshape(
        c, 9 * k_in // 16, n // 16, 32, 8)


def pack_slices(kernel: torch.Tensor, clusters: int, dtype: torch.dtype,
                groups: int = 1) -> torch.Tensor:
    """A weight's per-CTA column slices as the kernels read them: in
    fragment order in bf16, plain [C,9,K,N] in f32."""
    slices = column_slices(kernel.to(dtype), clusters, groups)
    if dtype == torch.bfloat16:
        return fragment_order(slices)
    return slices.contiguous()


def align128(nbytes: int) -> int:
    return -(-nbytes // 128) * 128


def padded_grid(h: int, w: int) -> tuple[int, int]:
    """(Mpad, R) of csrc/cluster_conv.cuh's padded grid: output rows on the
    H x (W+2) grid rounded up to 16, and rows of a padded operand."""
    mpad = -(-h * (w + 2) // 16) * 16
    return mpad, mpad + 2 * (w + 2) + 2


def pad_bytes(h: int, w: int, channels: int, elem: int) -> int:
    """Bytes of a padded operand (row stride channels + 8)."""
    return align128(padded_grid(h, w)[1] * (channels + 8) * elem)


def acc_bytes(h: int, w: int, columns: int, elem: int,
              k_groups: int = K_GROUPS) -> int:
    """Bytes of the conv's partial sums: `k_groups` planes in bf16, one in
    f32, of Mpad rows of stride columns + 8 floats."""
    planes = k_groups if elem == 2 else 1
    return align128(padded_grid(h, w)[0] * (columns + 8) * 4 * planes)


def smem_bytes(h: int, w: int, units: int, elem: int) -> int:
    """Shared memory of one CTA of kernel B1, as `csrc/convgru_fwd.cu`
    lays it out: weight slices (bf16 only), hpad, rhpad, acc, own h and u,
    two wx slices."""
    ns = units // cluster_size(units)
    hw = h * w
    weights = (align128(9 * units * 2 * ns * elem)
               + align128(9 * units * ns * elem)) if elem == 2 else 0
    return (weights + 2 * pad_bytes(h, w, units, elem)
            + acc_bytes(h, w, 2 * ns, elem) + 2 * align128(hw * ns * 4)
            + align128(2 * 3 * hw * ns * elem))


def cluster_kernel_takes(smem: Callable[[int, int, int, int], int], h: int,
                         w: int, units: int, dtype: torch.dtype,
                         kernel: tuple[int, int] = (3, 3)) -> bool:
    """The rule of the cluster kernels B1, B2 and B3: whether one takes U
    units with `kernel`-sized state convs on an H x W grid in `dtype` (the
    dtype of its conv operands): a 3x3 cell, a dtype of `_DTYPES`, U a
    positive multiple of 16, and one CTA's shared memory, `smem(h, w,
    units, elem)`, within `SMEM_LIMIT`. A pure function of the shapes."""
    return (tuple(kernel) == (3, 3) and dtype in _DTYPES and units >= 16
            and units % 16 == 0
            and smem(h, w, units, _DTYPES[dtype]) <= SMEM_LIMIT)


def kernel_takes(h: int, w: int, units: int, dtype: torch.dtype,
                 kernel: tuple[int, int] = (3, 3)) -> bool:
    """Whether kernel B1 takes U units with `kernel`-sized state convs on an
    H x W grid, wx in `dtype` (`cluster_kernel_takes` with B1's
    `smem_bytes`); `_launch` still raises on what it refuses."""
    return cluster_kernel_takes(smem_bytes, h, w, units, dtype, kernel)


def flops(t: int, b: int, h: int, w: int, units: int, gates: int) -> int:
    """The contractions of one launch of a 3x3 cluster kernel, as
    `utils/mfu.py` counts them: T*B*H*W*9*U*(gates*U)*2 (gates = 3 for B1,
    B2 and B4's phases G and W, 4 for B3)."""
    return 2 * t * b * h * w * 9 * units * gates * units


def check_fits(kernel: str, need: int, h: int, w: int, units: int) -> None:
    """Raise ValueError if a CTA of `kernel` needs more shared memory than
    the card gives one."""
    if need > SMEM_LIMIT:
        raise ValueError(f"{kernel} needs {need} B of shared memory per CTA "
                         f"at H={h} W={w} U={units} (cluster of "
                         f"{cluster_size(units)}; limit {SMEM_LIMIT})")


def aligned(x: torch.Tensor) -> torch.Tensor:
    """x, or a copy of it whose data starts on 16 bytes (the kernels'
    cp.async and vector loads need that)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


# Plain conv helpers of the backward's and B5's plain versions (the JAX
# package's `_conv3x3_transpose`, `_patches`, `_kernel_grad`), by the
# numerics rule: operands rounded to the compute dtype, sums in f32.

def mode_of(wx: torch.Tensor) -> Optional[torch.dtype]:
    """The compute dtype the recurrence ran in: None for f32, else wx's."""
    return None if wx.dtype == torch.float32 else wx.dtype


def round_to(x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """x rounded to `compute_dtype` (a conv operand, by the numerics rule)
    and returned in f32; x in f32 when compute_dtype is None."""
    return x.float() if compute_dtype is None else x.to(compute_dtype).float()


def conv3x3(x: torch.Tensor, kernel: torch.Tensor,
            compute_dtype=None) -> torch.Tensor:
    """SAME 3x3 conv [N,H,W,Cin] x [3,3,Cin,Cout] -> [N,H,W,Cout] with both
    operands rounded to `compute_dtype`, products summed in f32."""
    return conv2d(round_to(x, compute_dtype), round_to(kernel, compute_dtype))


def transposed_weight(kernel: torch.Tensor) -> torch.Tensor:
    """[3,3,Cin,Cout] -> [3,3,Cout,Cin], flipped spatially: the SAME-conv
    kernel whose conv is the transposed conv of `kernel`."""
    return kernel.flip(0, 1).transpose(2, 3)


def conv3x3_transpose(g: torch.Tensor, kernel: torch.Tensor,
                      compute_dtype=None) -> torch.Tensor:
    """Gradient wrt the input of a SAME 3x3 conv: correlate g [N,H,W,Cout]
    with kernel [3,3,Cin,Cout] -> [N,H,W,Cin]. Equals a SAME conv with the
    spatially flipped, in/out-swapped kernel (`_conv3x3_transpose`)."""
    return conv3x3(g, transposed_weight(kernel), compute_dtype)


def patches(x: torch.Tensor) -> torch.Tensor:
    """[N,H,W,C] -> [N,H,W,9,C] of 3x3 SAME neighborhoods (`_patches`)."""
    h, w = x.shape[1:3]
    padded = F.pad(x, (0, 0, 1, 1, 1, 1))
    return torch.stack([padded[:, dy:dy + h, dx:dx + w, :]
                        for dy in range(3) for dx in range(3)], dim=3)


def kernel_grad(x: torch.Tensor, g: torch.Tensor,
                compute_dtype=None) -> torch.Tensor:
    """Gradient wrt the kernel of a SAME 3x3 conv, summed over every
    leading axis: patches(x)^T g as ONE matmul (`_kernel_grad`).
    x [...,H,W,Cin], g [...,H,W,Cout] -> [3,3,Cin,Cout] in f32."""
    h, w, cin = x.shape[-3:]
    cout = g.shape[-1]
    p = patches(round_to(x, compute_dtype).reshape(-1, h, w, cin))
    grad = p.reshape(-1, 9 * cin).T @ round_to(g, compute_dtype).reshape(
        -1, cout)
    return grad.reshape(3, 3, cin, cout)


def hprev_of(h0: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """The h_{t-1} stream [h0, ys[:-1]] in f32."""
    return torch.cat([h0[None].float(), ys[:-1].float()], dim=0)


def _launch(u_zr: torch.Tensor, u_c: torch.Tensor, wx: torch.Tensor,
            h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    global launches
    if wx.dim() != 5 or h0.dim() != 4:
        raise ValueError(f"need wx [T,B,H,W,3U] and h0 [B,H,W,U]; got "
                         f"{tuple(wx.shape)} and {tuple(h0.shape)}")
    t, b, hh, ww, three_u = wx.shape
    units = three_u // 3
    if wx.dtype not in _DTYPES:
        raise ValueError(f"wx dtype must be bfloat16 or float32, got "
                         f"{wx.dtype}")
    if (three_u != 3 * units or units % 16 or t < 1 or b < 1
            or tuple(h0.shape) != (b, hh, ww, units)
            or tuple(u_zr.shape) != (3, 3, units, 2 * units)
            or tuple(u_c.shape) != (3, 3, units, units)):
        raise ValueError(
            f"convgru kernel takes wx [T>=1,B>=1,H,W,3U] with U a multiple "
            f"of 16, h0 [B,H,W,U], U_zr [3,3,U,2U], U_c [3,3,U,U]; got "
            f"wx {tuple(wx.shape)}, h0 {tuple(h0.shape)}, U_zr "
            f"{tuple(u_zr.shape)}, U_c {tuple(u_c.shape)}")
    device = build.same_device("convgru_fwd", u_zr, u_c, wx, h0)
    elem = _DTYPES[wx.dtype]
    check_fits("convgru_fwd", smem_bytes(hh, ww, units, elem), hh, ww, units)
    clusters = cluster_size(units)
    wx = aligned(wx.contiguous())
    wzr = pack_slices(u_zr, clusters, wx.dtype, groups=2)
    wc = pack_slices(u_c, clusters, wx.dtype)
    h0 = aligned(h0.float().contiguous())
    ys = torch.empty((t, b, hh, ww, units), dtype=torch.float32,
                     device=device)
    h_final = torch.empty((b, hh, ww, units), dtype=torch.float32,
                          device=device)
    build.launch("convgru_fwd", device, wx.data_ptr(), wzr.data_ptr(),
                 wc.data_ptr(), h0.data_ptr(), ys.data_ptr(),
                 h_final.data_ptr(), t, b, hh, ww, units, elem)
    with _count_lock:
        launches += 1
    mfu.add_kernel_flops("convgru_fwd", flops(t, b, hh, ww, units, 3))
    return h_final, ys


def convgru_recurrence(fused: dict, wx_all: torch.Tensor, h0: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Recurrence over precomputed input gates wx_all [T,B,H,W,3U] (bf16
    or f32) from h0 [B,H,W,U] -> (final_h, ys [T,B,H,W,U]) in f32.
    `fused` is `ConvGRU.fuse(params)`; the state convs run in wx's dtype."""
    if wx_all.device.type == "cuda":
        return _launch(fused["Uh_zr"], fused["U_c"], wx_all, h0)
    if wx_all.device.type != "cpu":
        raise ValueError(f"no ConvGRU kernel for device {wx_all.device}")
    cdt = None if wx_all.dtype == torch.float32 else wx_all.dtype
    return ConvGRU.scan_precomputed(fused, wx_all, h0.float(), cdt)


def convgru_scan(params, x_tbhwc: torch.Tensor, h0: torch.Tensor,
                 compute_dtype=torch.bfloat16
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """`ConvGRU.scan` with the recurrence in the kernel: the input-side conv
    over all T*B frames stays one library conv, then `convgru_recurrence`.
    Returns (final_h, ys) like the plain scan."""
    fused = ConvGRU.fuse(params)
    wx_all = ConvGRU.input_gates(fused, x_tbhwc, compute_dtype)
    return convgru_recurrence(fused, wx_all, h0)
