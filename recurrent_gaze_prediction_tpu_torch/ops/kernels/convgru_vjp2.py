"""ConvGRU custom backward, v2 (decomposed): the hand-written CUDA kernel of
its sequential stage, that stage's plain version, and the autograd Function
the trainer runs, whose three stages are B4's three kernels.

Replaces the TPU kernel `_dh_bwd_kernel` of the JAX package's
`ops/pallas/convgru_vjp2.py` (`_dh_bwd_pallas`, custom VJP `convgru_fused`,
entry point `convgru_scan_trainable_v2`). There only the inherently
sequential piece is a kernel and XLA computes stages 1 and 3; here all
three are hand-written kernels, the phases of B4 (`convgru_vjp.py`):

  stage 1 (phase G, `convgru_vjp.bwd_gates`, all T*B frames at once):
      recompute u, r, c from the stored hidden states;
  stage 2 (kernel `csrc/convgru_bwd.cu`, reverse time, one thread-block
      cluster per batch element with the output channels split over its
      CTAs, as kernel B1): propagate dh_{t-1} = dh_t.u + drh.r +
      conv_T(dzr, U_zr), emitting dzr = [du_pre|dr_pre] and da per step;
  stage 3 (phase W, `convgru_vjp.wgrad`): dU_zr = sum_t patches(h_{t-1})^T
      dzr_t, dU_c = sum_t patches(r.h)^T da_t; and dwx = [dzr|da].

Bound of the kernel on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s) at T=42,
U=128 in bf16: bytes, eight f32 [T,B,7,7,U] streams plus the weights (68 MB
at B=8, 20.4 us; 136 MB at B=16, 40.7 us); its two transposed convs are
14.6 / 29.1 GFLOP (14.7 / 29.5 us).

Numerics rule: as in `convgru_vjp.py` (elementwise math in f32; in bf16
mode every conv and matmul operand rounded to bf16, products summed in
f32). The stage-1 recompute rounds h_{t-1} and r*h_{t-1} exactly as the
forward kernel did, so it sees the forward's gates.

On a CUDA tensor `dh_bwd` launches the kernel or raises (no fallback); on
a CPU tensor it runs the plain version, `dh_bwd_plain`. So V2's backward
launches G, B2 and W once each on the card, and on the CPU runs
`recompute_gates`, `dh_bwd_plain` and `wgrad_plain`.
"""

from __future__ import annotations

import threading

import torch

from ..cells import ConvGRU
from ...utils import mfu
from . import build
from .convgru import (SMEM_LIMIT, acc_bytes, align128, aligned, check_fits,
                      cluster_size, convgru_recurrence, flops, pack_slices,
                      pad_bytes)
from .convgru_vjp import (bwd_gates, conv3x3, conv3x3_transpose,
                          convgru_bwd_phased, hprev_of, mode_of,
                          transposed_weight, wgrad)

# Launches of the CUDA kernel in this process; chip_smoke.py resets it to
# 0 before driving a path and reads it after.
launches = 0
_count_lock = threading.Lock()

_DTYPES = {torch.bfloat16: 2, torch.float32: 4}


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
    None), reckoned as `convgru.kernel_takes` is for B1: 3x3 only."""
    return (tuple(kernel) == (3, 3) and dtype in _DTYPES and units >= 16
            and units % 16 == 0
            and smem_bytes(h, w, units, _DTYPES[dtype]) <= SMEM_LIMIT)


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


def recompute_gates(uzr, uc, wx, h0, ys) -> tuple[torch.Tensor, ...]:
    """Stage 1's plain version (phase G's): u, r, c, h_{t-1} and r*h_{t-1}
    [T,B,H,W,U] in f32 from the forward's wx, h0 and ys, as two convs over
    all T*B frames.
    The conv operands round as the forward kernel's did (by wx's dtype),
    so these are the gates the forward saw."""
    cdt = mode_of(wx)
    units = uc.shape[-1]
    t, b = wx.shape[:2]
    hprev = hprev_of(h0, ys)
    wxf = wx.float()

    def frames(x):  # [T,B,H,W,C] -> [T*B,H,W,C]
        return x.reshape(t * b, *x.shape[2:])

    uh = conv3x3(frames(hprev), uzr, cdt).reshape(*hprev.shape[:-1],
                                                  2 * units)
    u = torch.sigmoid(wxf[..., :units] + uh[..., :units])
    r = torch.sigmoid(wxf[..., units:2 * units] + uh[..., units:])
    rh = r * hprev
    c = torch.tanh(wxf[..., 2 * units:]
                   + conv3x3(frames(rh), uc, cdt).reshape(u.shape))
    return u, r, c, hprev, rh


class ConvGRUFusedV2(torch.autograd.Function):
    """The differentiable recurrence over precomputed gates, the port of
    `convgru_fused`: forward is kernel B1 (`convgru_recurrence`), backward
    the three stages above (phase G, B2, phase W). Saves only ys, like the
    JAX custom VJP."""

    @staticmethod
    def forward(ctx, uzr, uc, wx, h0):
        _, ys = convgru_recurrence({"Uh_zr": uzr, "U_c": uc}, wx, h0)
        ctx.save_for_backward(uzr, uc, wx, h0, ys)
        return ys

    @staticmethod
    def backward(ctx, g):
        uzr, uc, wx, h0, ys = ctx.saved_tensors
        # phase G, kernel B2, phase W (on a CPU tensor their plain
        # versions); dwx = [dzr|da]
        dwx, dh0, duzr, duc = convgru_bwd_phased(
            uzr, uc, wx, ys, h0, g, gates=bwd_gates, recursion=dh_bwd,
            tail=wgrad)
        return (duzr.to(uzr.dtype), duc.to(uc.dtype), dwx.to(wx.dtype),
                dh0.to(h0.dtype))


def convgru_scan_trainable_v2(params, x_tbhwc: torch.Tensor,
                              h0: torch.Tensor, compute_dtype=torch.bfloat16
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for `ConvGRU.scan`: kernel B1 forward, decomposed backward
    (phase G, kernel B2, phase W). The input-side conv stays one library
    conv, differentiated by autograd. Returns (ys[-1], ys)."""
    fused = ConvGRU.fuse(params)
    wx_all = ConvGRU.input_gates(fused, x_tbhwc, compute_dtype)
    ys = ConvGRUFusedV2.apply(fused["Uh_zr"], fused["U_c"], wx_all,
                              h0.float())
    return ys[-1], ys
