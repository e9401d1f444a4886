"""Stage 2 of the ConvGRU backward, kernel B2: the hand-written CUDA kernel
of its sequential stage and that stage's plain version.

Replaces the TPU kernel `_dh_bwd_kernel` of the JAX package's
`ops/pallas/convgru_vjp2.py` (`_dh_bwd_pallas`). There only this inherently
sequential stage is a kernel and XLA computes the gate recompute before it
and the weight gradients after it; here those are B4's phases G and W
(`convgru_vjp.py`, which also holds the autograd Function over all three).
The kernel (`csrc/convgru_bwd.cu`) walks time in reverse on one
thread-block cluster per batch element, the output channels split over its
CTAs as in B1, and propagates dh_{t-1} = dh_t.u + drh.r + conv_T(dzr, U_zr),
emitting dzr = [du_pre|dr_pre] and da per step.

Bound of the kernel on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s) at T=42,
U=128 in bf16: bytes, eight f32 [T,B,7,7,U] streams plus the weights (68 MB
at B=8, 20.4 us; 136 MB at B=16, 40.7 us); its two transposed convs are
14.6 / 29.1 GFLOP (14.7 / 29.5 us).

Numerics rule: `convgru.py`'s plain conv helpers' (operands rounded to the
compute dtype, sums in f32); phase G rounds h_{t-1} and r*h_{t-1} as the
forward kernel did, so B2 sees the forward's gates.

On a CUDA tensor `dh_bwd` launches the kernel or raises (no fallback); on
a CPU tensor it runs the plain version, `dh_bwd_plain`.
"""

from __future__ import annotations

import threading

import torch

from ...utils import mfu
from . import build
from .convgru import (_DTYPES, acc_bytes, align128, aligned, check_fits,
                      cluster_kernel_takes, cluster_size, conv3x3_transpose,
                      flops, pack_slices, pad_bytes, transposed_weight)

# Launches of the CUDA kernel in this process; chip_smoke.py resets it to
# 0 before driving a path and reads it after.
launches = 0
_count_lock = threading.Lock()


def dh_bwd_plain(u, r, c, hprev, g, uzr, uc, compute_dtype=None
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the kernel, step by step as `_dh_bwd_kernel`:
    u, r, c, hprev, g [T,B,H,W,U] f32 -> (dzr [T,B,H,W,2U], da, dh0)."""
    dh = torch.zeros_like(hprev[0])
    dzrs, das = [], []
    for t in reversed(range(u.shape[0])):
        ut, rt, ct, h_prev = u[t], r[t], c[t], hprev[t]
        dh_new = g[t] + dh
        du_pre = dh_new * (h_prev - ct) * ut * (1.0 - ut)
        da = dh_new * (1.0 - ut) * (1.0 - ct * ct)
        drh = conv3x3_transpose(da, uc, compute_dtype)
        dr_pre = drh * h_prev * rt * (1.0 - rt)
        dzr = torch.cat([du_pre, dr_pre], dim=-1)
        dh = dh_new * ut + drh * rt + conv3x3_transpose(dzr, uzr,
                                                         compute_dtype)
        dzrs.append(dzr)
        das.append(da)
    return torch.stack(dzrs[::-1]), torch.stack(das[::-1]), dh


def smem_bytes(h: int, w: int, units: int, elem: int) -> int:
    """Shared memory of one CTA of kernel B2, as `csrc/convgru_bwd.cu` lays
    it out: weight slices (bf16 only), dapad, zpad, acc, own dh, the five
    input slices."""
    ns = units // cluster_size(units)
    hw = h * w
    weights = (align128(9 * units * ns * elem)
               + align128(9 * 2 * units * ns * elem)) if elem == 2 else 0
    return (weights + pad_bytes(h, w, units, elem)
            + pad_bytes(h, w, 2 * units, elem) + acc_bytes(h, w, ns, elem)
            + align128(hw * ns * 4) + align128(5 * hw * ns * 4))


def kernel_takes(h: int, w: int, units: int, dtype: torch.dtype,
                 kernel: tuple[int, int] = (3, 3)) -> bool:
    """Whether kernel B2 takes U units of a `kernel`-sized cell on an H x W
    grid with conv operands in `dtype` (bf16, or f32 for compute dtype
    None), by `convgru.cluster_kernel_takes` with B2's `smem_bytes`."""
    return cluster_kernel_takes(smem_bytes, h, w, units, dtype, kernel)


def _launch(u, r, c, hprev, g, uzr, uc, compute_dtype
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    global launches
    if u.dim() != 5:
        raise ValueError(f"need u [T,B,H,W,U]; got {tuple(u.shape)}")
    t, b, hh, ww, units = u.shape
    wdt = torch.float32 if compute_dtype is None else compute_dtype
    if wdt not in _DTYPES:
        raise ValueError(f"compute dtype must be bfloat16 or float32 (None), "
                         f"got {compute_dtype}")
    if (units % 16 or t < 1 or b < 1
            or any(x.shape != u.shape for x in (r, c, hprev, g))
            or tuple(uzr.shape) != (3, 3, units, 2 * units)
            or tuple(uc.shape) != (3, 3, units, units)):
        raise ValueError(
            f"convgru_bwd takes u, r, c, hprev, g [T>=1,B>=1,H,W,U] with U a "
            f"multiple of 16, U_zr [3,3,U,2U], U_c [3,3,U,U]; got "
            f"{[tuple(x.shape) for x in (u, r, c, hprev, g)]}, U_zr "
            f"{tuple(uzr.shape)}, U_c {tuple(uc.shape)}")
    device = build.same_device("convgru_bwd", u, r, c, hprev, g, uzr, uc)
    elem = _DTYPES[wdt]
    check_fits("convgru_bwd", smem_bytes(hh, ww, units, elem), hh, ww, units)
    clusters = cluster_size(units)
    streams = [aligned(x.float().contiguous()) for x in (u, r, c, hprev, g)]
    uzr_t = pack_slices(transposed_weight(uzr), clusters, wdt)
    uc_t = pack_slices(transposed_weight(uc), clusters, wdt)
    f32 = dict(dtype=torch.float32, device=device)
    dzr = torch.empty((t, b, hh, ww, 2 * units), **f32)
    da = torch.empty((t, b, hh, ww, units), **f32)
    dh0 = torch.empty((b, hh, ww, units), **f32)
    build.launch("convgru_bwd", device, *(x.data_ptr() for x in streams),
                 uzr_t.data_ptr(), uc_t.data_ptr(), dzr.data_ptr(),
                 da.data_ptr(), dh0.data_ptr(), t, b, hh, ww, units, elem)
    with _count_lock:
        launches += 1
    # the two transposed state convs: B1's contractions
    mfu.add_kernel_flops("convgru_bwd", flops(t, b, hh, ww, units, 3))
    return dzr, da, dh0


def dh_bwd(u, r, c, hprev, g, uzr, uc, compute_dtype=None
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stage 2 of the backward (`_dh_bwd_pallas`): the reverse-time
    recursion of the state cotangent -> (dzr, da, dh0) in f32.
    `compute_dtype` (None = f32) is the dtype the convs' operands round
    to."""
    if u.device.type == "cuda":
        return _launch(u, r, c, hprev, g, uzr, uc, compute_dtype)
    if u.device.type != "cpu":
        raise ValueError(f"no ConvGRU backward kernel for device {u.device}")
    return dh_bwd_plain(u, r, c, hprev, g, uzr, uc, compute_dtype)
