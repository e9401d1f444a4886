"""A small-channel ConvGRU over its whole sequence, forward and backward:
kernel B5's wrappers, their plain versions, and the autograd Function the
cascade's top cell runs.

Replaces no Pallas kernel: the JAX package scans this cell with `lax.scan`
(the cascade's top cell, 64 input channels -> U=3 units with 5x5 state
convs at 49x49). Its plain per-step loop, rematerialized, dispatched ~126
small ops a step; the kernel (`csrc/convgru_small.cu`) runs all T steps in
one launch forward and one backward.

Design: one CTA per batch element, with no traffic between CTAs, walks all
T steps with the whole padded state in shared memory (f32 state, a bf16
copy padded by the halo for the convs) and the weights resident; threads
own pixels and the convs run on the CUDA cores. So at B=28 it runs 28 CTAs
and is bound by a step's latency across T. The backward recomputes u, r, c
from the stored ys, carries dh in shared memory, and adds each step's
weight-gradient products, summed per thread, to that thread's running sums
(global scratch); the CTA sums its threads' sums in a fixed order and a
second launch sums the B partials in a fixed order (no atomics: the same
bits every run).

Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s) at B=28, T=42, K=5, U=3:
the forward's contractions are 2*T*B*H*W*K*K*U*3U = 3.81 GFLOP (3.9 us)
against 84.7 MB of wx and ys (25 us): bytes bound it. The backward's are
three times that (11.4 GFLOP, 11.6 us) against ~170 MB (51 us).

Numerics rule (as `convgru.py`'s plain conv helpers): the state and elementwise math in
f32; every conv operand (h, r*h, the weights, and the pre-activation
gradients fed to the transposed convs and the weight products) rounded to
bf16, products summed in f32, the sums not rounded. The plain versions here
round the same way, so the card's check compares like with like.

`kernel_takes` decides from the shapes, and takes only what is built and
tested: the cascade's top cell (a 5x5 kernel, U=3, wx in bf16) on a grid of
at most `MAX_PIXELS` (one group of five pixels a thread), within
`SMEM_LIMIT`. Every 3x3 cell is refused: the bottom cell (U=256) is B6's
(`convgru_grid.py`), every shape of B1 (U a multiple of 16) B1's. On a CUDA tensor the wrappers launch the
kernel or raise (no fallback); on a CPU tensor they run the plain versions
`forward_plain` and `backward_plain`. `launches` counts every launch of B5
(forward or backward), `bwd_launches` the backward's.
"""

from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from ..cells import ConvGRU
from ..layers import conv2d
from ...train.profiler import count
from ...utils import mfu
from . import build
from .convgru import (SMEM_LIMIT, align128, hprev_of, mode_of, round_to,
                      transposed_weight)

# Launches in this process: of B5 (forward and backward), and of its
# backward alone
launches = 0
bwd_launches = 0
_count_lock = threading.Lock()

# csrc/convgru_small.cu's constants: the CTA's threads, the pixels a
# thread owns, and the one (kernel size, U) that is built
THREADS = 512
MAX_PIXELS = THREADS * 5
KERNEL = 5
UNITS = 3


def smem_bytes(h: int, w: int, k: int, units: int, backward: bool) -> int:
    """Shared memory of one CTA, as `csrc/convgru_small.cu` lays it out:
    the weights' padded rows; forward: the padded h and r*h (4 bf16 slots a
    pixel) and the f32 h and u; backward: the padded h, r*h, da (4 slots)
    and [du_pre|dr_pre] (8 slots) and the f32 u, r and dh."""
    hw, padded = h * w, (h + k - 1) * (w + k - 1)
    weights = align128(4 * k * k * units * 12)
    state = align128(4 * hw * units)
    if not backward:
        return weights + 2 * align128(8 * padded) + 2 * state
    return (weights + 3 * align128(8 * padded) + align128(16 * padded)
            + 3 * state)


def kernel_takes(h: int, w: int, units: int, dtype: torch.dtype,
                 kernel: tuple[int, int] = (3, 3)) -> bool:
    """Whether kernel B5 takes a cell of U units with `kernel`-sized state
    convs on an H x W grid, wx in `dtype`: a KERNEL x KERNEL kernel, U =
    UNITS, bf16, 1 <= H*W <= MAX_PIXELS, and the backward's shared memory
    (the larger) within SMEM_LIMIT. A pure function of the shapes."""
    return (tuple(kernel) == (KERNEL, KERNEL) and units == UNITS
            and dtype == torch.bfloat16 and h >= 1 and w >= 1
            and h * w <= MAX_PIXELS
            and smem_bytes(h, w, KERNEL, units, True) <= SMEM_LIMIT)


def flops(t: int, b: int, h: int, w: int, k: int, units: int) -> int:
    """The contractions of one forward launch: T*B*H*W*K*K*U*3U*2 (the
    backward's are three times these)."""
    return 2 * t * b * h * w * k * k * units * 3 * units


# ------------------------------------------------------------ plain versions

def state_conv(x: torch.Tensor, kernel: torch.Tensor,
               compute_dtype=None) -> torch.Tensor:
    """SAME KxK conv [N,H,W,Cin] x [K,K,Cin,Cout] -> [N,H,W,Cout] with both
    operands rounded to `compute_dtype`, summed in f32, the sum unrounded."""
    return conv2d(round_to(x, compute_dtype), round_to(kernel, compute_dtype))


def state_conv_transpose(g: torch.Tensor, kernel: torch.Tensor,
                         compute_dtype=None) -> torch.Tensor:
    """Gradient wrt the input of `state_conv(., kernel)`: the SAME conv of
    g [N,H,W,Cout] with the flipped, in/out-swapped kernel -> [N,H,W,Cin]."""
    return state_conv(g, transposed_weight(kernel), compute_dtype)


def weight_grad(x: torch.Tensor, g: torch.Tensor, k: int,
                compute_dtype=None) -> torch.Tensor:
    """Gradient wrt the kernel of a SAME KxK conv, summed over the frames:
    patches(x)^T g, x [N,H,W,Cin], g [N,H,W,Cout] -> [K,K,Cin,Cout] f32."""
    n, h, w, cin = x.shape
    pad = k // 2
    padded = F.pad(round_to(x, compute_dtype), (0, 0, pad, pad, pad, pad))
    patches = torch.stack([padded[:, dy:dy + h, dx:dx + w, :]
                           for dy in range(k) for dx in range(k)], dim=3)
    grad = (patches.reshape(-1, k * k * cin).T
            @ round_to(g, compute_dtype).reshape(-1, g.shape[-1]))
    return grad.reshape(k, k, cin, g.shape[-1])


def _gates(uzr, uc, x, h, compute_dtype):
    """One step's u, r, r*h and c from wx `x` and h_{t-1} `h` (f32)."""
    units = uc.shape[-1]
    uh = state_conv(h, uzr, compute_dtype)
    u = torch.sigmoid(x[..., :units] + uh[..., :units])
    r = torch.sigmoid(x[..., units:2 * units] + uh[..., units:])
    rh = r * h
    c = torch.tanh(x[..., 2 * units:] + state_conv(rh, uc, compute_dtype))
    return u, r, rh, c


def forward_plain(uzr: torch.Tensor, uc: torch.Tensor, wx: torch.Tensor,
                  h0: torch.Tensor) -> torch.Tensor:
    """The plain version of the forward kernel, step by step as
    `ConvGRU.scan_precomputed`: wx [T,B,H,W,3U], h0 [B,H,W,U] -> ys
    [T,B,H,W,U] in f32, the convs' operands rounded to wx's dtype. A plain
    scan on the host: counts its T steps in `recurrence.plain_steps`."""
    cdt = mode_of(wx)
    count("recurrence.plain_steps", len(wx))
    h = h0.float()
    ys = []
    for x in wx:
        u, _, _, c = _gates(uzr, uc, x.float(), h, cdt)
        h = u * h + (1.0 - u) * c
        ys.append(h)
    return torch.stack(ys)


def backward_plain(uzr, uc, wx, h0, ys, g) -> tuple[torch.Tensor, ...]:
    """The plain version of the backward kernel, an explicit reverse-time
    recursion (as `convgru_vjp2.dh_bwd_plain`, with the gates recomputed
    from ys as the kernel does): -> (dwx [T,B,H,W,3U], dh0, dU_zr, dU_c),
    all f32."""
    cdt = mode_of(wx)
    k = uc.shape[0]
    hprev = hprev_of(h0, ys)
    dh = torch.zeros_like(hprev[0])
    duzr = torch.zeros(uzr.shape, dtype=torch.float32, device=wx.device)
    duc = torch.zeros(uc.shape, dtype=torch.float32, device=wx.device)
    dwx = []
    for t in reversed(range(wx.shape[0])):
        h = hprev[t]
        u, r, rh, c = _gates(uzr, uc, wx[t].float(), h, cdt)
        dh_new = g[t].float() + dh
        du_pre = dh_new * (h - c) * u * (1.0 - u)
        da = dh_new * (1.0 - u) * (1.0 - c * c)
        drh = state_conv_transpose(da, uc, cdt)
        dr_pre = drh * h * r * (1.0 - r)
        dzr = torch.cat([du_pre, dr_pre], dim=-1)
        dh = dh_new * u + drh * r + state_conv_transpose(dzr, uzr, cdt)
        duc = duc + weight_grad(rh, da, k, cdt)
        duzr = duzr + weight_grad(h, dzr, k, cdt)
        dwx.append(torch.cat([du_pre, dr_pre, da], dim=-1))
    return torch.stack(dwx[::-1]), dh, duzr, duc


# ------------------------------------------------------------------ launches

def _check(uzr, uc, wx, h0) -> tuple[int, ...]:
    """(T, B, H, W, K, U) of a call the kernel takes; raises otherwise."""
    if wx.dim() != 5 or h0.dim() != 4 or uzr.dim() != 4:
        raise ValueError(f"need wx [T,B,H,W,3U], h0 [B,H,W,U] and U_zr "
                         f"[K,K,U,2U]; got {tuple(wx.shape)}, "
                         f"{tuple(h0.shape)} and {tuple(uzr.shape)}")
    t, b, hh, ww, three_u = wx.shape
    units, k = three_u // 3, uzr.shape[0]
    if (three_u != 3 * units or t < 1 or b < 1
            or tuple(h0.shape) != (b, hh, ww, units)
            or tuple(uzr.shape) != (k, k, units, 2 * units)
            or tuple(uc.shape) != (k, k, units, units)
            or not kernel_takes(hh, ww, units, wx.dtype, (k, k))):
        raise ValueError(
            f"convgru_small takes wx [T>=1,B>=1,H,W,3U] in bf16 with "
            f"U = {UNITS} and H*W <= {MAX_PIXELS}, h0 [B,H,W,U], U_zr "
            f"[K,K,U,2U] and U_c [K,K,U,U] with K = {KERNEL}; got wx "
            f"{tuple(wx.shape)} {wx.dtype}, h0 {tuple(h0.shape)}, U_zr "
            f"{tuple(uzr.shape)}, U_c {tuple(uc.shape)}")
    return t, b, hh, ww, k, units


def _weights(uzr, uc):
    """The weights as the kernel reads them: f32 values rounded to bf16."""
    return (uzr.to(torch.bfloat16).float().contiguous(),
            uc.to(torch.bfloat16).float().contiguous())


def _launch_fwd(uzr, uc, wx, h0) -> torch.Tensor:
    global launches
    t, b, hh, ww, k, units = _check(uzr, uc, wx, h0)
    device = build.same_device("convgru_small_fwd", uzr, uc, wx, h0)
    wzr, wc = _weights(uzr, uc)
    wx = wx.contiguous()
    h0 = h0.float().contiguous()
    ys = torch.empty((t, b, hh, ww, units), dtype=torch.float32,
                     device=device)
    build.launch("convgru_small_fwd", device, wx.data_ptr(), wzr.data_ptr(),
                 wc.data_ptr(), h0.data_ptr(), ys.data_ptr(), t, b, hh, ww,
                 k, units)
    with _count_lock:
        launches += 1
    mfu.add_kernel_flops("convgru_small_fwd", flops(t, b, hh, ww, k, units))
    return ys


def _launch_bwd(uzr, uc, wx, h0, ys, g) -> tuple[torch.Tensor, ...]:
    global launches, bwd_launches
    t, b, hh, ww, k, units = _check(uzr, uc, wx, h0)
    if ys.shape != g.shape or tuple(ys.shape) != (t, b, hh, ww, units):
        raise ValueError(f"convgru_small backward needs ys and g "
                         f"[T,B,H,W,U] = {(t, b, hh, ww, units)}; got "
                         f"{tuple(ys.shape)} and {tuple(g.shape)}")
    device = build.same_device("convgru_small_bwd", uzr, uc, wx, h0, ys, g)
    wzr, wc = _weights(uzr, uc)
    wx, ys = wx.contiguous(), ys.float().contiguous()
    h0, g = h0.float().contiguous(), g.float().contiguous()
    n = k * k * 3 * units * units
    f32 = dict(dtype=torch.float32, device=device)
    dwx = torch.empty_like(wx)
    dh0 = torch.empty((b, hh, ww, units), **f32)
    # scratch: each thread's running weight-gradient sums, each CTA's
    sums = torch.empty((b, THREADS, 3 * units * units), **f32)
    partial = torch.empty((b, n), **f32)
    dw = torch.empty((n,), **f32)
    build.launch("convgru_small_bwd", device, wx.data_ptr(), ys.data_ptr(),
                 h0.data_ptr(), g.data_ptr(), wzr.data_ptr(), wc.data_ptr(),
                 dwx.data_ptr(), dh0.data_ptr(), sums.data_ptr(),
                 partial.data_ptr(), dw.data_ptr(), t, b, hh, ww, k, units)
    with _count_lock:
        launches += 1
        bwd_launches += 1
    # the recompute, the two transposed convs and the weight products
    mfu.add_kernel_flops("convgru_small_bwd",
                         3 * flops(t, b, hh, ww, k, units))
    split = k * k * units * 2 * units
    return (dwx, dh0, dw[:split].view(k, k, units, 2 * units),
            dw[split:].view(k, k, units, units))


def recurrence(uzr, uc, wx, h0) -> torch.Tensor:
    """ys [T,B,H,W,U] f32 from wx [T,B,H,W,3U] and h0: kernel B5 on a CUDA
    tensor, `forward_plain` on a CPU tensor."""
    if wx.device.type == "cuda":
        return _launch_fwd(uzr, uc, wx, h0)
    if wx.device.type != "cpu":
        raise ValueError(f"no small ConvGRU kernel for device {wx.device}")
    return forward_plain(uzr, uc, wx, h0)


def recurrence_bwd(uzr, uc, wx, h0, ys, g) -> tuple[torch.Tensor, ...]:
    """(dwx in wx's dtype, dh0, dU_zr, dU_c): kernel B5's backward on a CUDA
    tensor, `backward_plain` on a CPU tensor."""
    if wx.device.type == "cuda":
        return _launch_bwd(uzr, uc, wx, h0, ys, g)
    if wx.device.type != "cpu":
        raise ValueError(f"no small ConvGRU kernel for device {wx.device}")
    dwx, dh0, duzr, duc = backward_plain(uzr, uc, wx, h0, ys, g)
    return dwx.to(wx.dtype), dh0, duzr, duc


class ConvGRUSmall(torch.autograd.Function):
    """The differentiable recurrence over precomputed gates: (U_zr, U_c,
    wx, h0) -> ys, forward and backward each one launch of B5. Saves only
    its inputs and ys; the backward recomputes the gates."""

    @staticmethod
    def forward(ctx, uzr, uc, wx, h0):
        ys = recurrence(uzr, uc, wx, h0)
        ctx.save_for_backward(uzr, uc, wx, h0, ys)
        return ys

    @staticmethod
    def backward(ctx, g):
        uzr, uc, wx, h0, ys = ctx.saved_tensors
        dwx, dh0, duzr, duc = recurrence_bwd(uzr, uc, wx, h0, ys, g)
        return duzr.to(uzr.dtype), duc.to(uc.dtype), dwx, dh0.to(h0.dtype)


def convgru_scan_small(params, x_tbhwc: torch.Tensor, h0: torch.Tensor,
                       compute_dtype=torch.bfloat16
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for `ConvGRU.scan` on the cells B5 takes: the input-side
    conv over all T*B frames stays one library conv, differentiated by
    autograd; the recurrence is `ConvGRUSmall`. Returns (ys[-1], ys)."""
    fused = ConvGRU.fuse(params)
    wx_all = ConvGRU.input_gates(fused, x_tbhwc, compute_dtype)
    ys = ConvGRUSmall.apply(fused["Uh_zr"], fused["U_c"], wx_all,
                            h0.float())
    return ys[-1], ys
