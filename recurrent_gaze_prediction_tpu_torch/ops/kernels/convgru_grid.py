"""A wide ConvGRU on a small grid over its whole sequence: kernel B6's
wrappers, their plain versions, and the autograd Function the cascade's
bottom cell runs.

Replaces no Pallas kernel: the JAX package scans this cell with `lax.scan`
(the cascade's bottom cell, 512 input channels -> U=256 units with 3x3
state convs at 7x7). The cluster kernels B1/B2 keep a CTA's weight slice
resident, 636 KB a CTA at U=256, so they refuse it; its plain per-step
loop, rematerialized, dispatched every step's convs and gate math from the
host. The kernel (`csrc/convgru_grid.cu`) runs all T steps in one launch
forward and the backward's reverse-time recursion in one more; the weight
gradients then go through phase W (`convgru_vjp.wgrad`, which takes this
shape), in parallel over T*B.

Design: a CTA owns one batch element's rows and a 64-channel slice of the
outputs (B * U/64 CTAs, 112 at B=28, U=256, in a cooperative launch); the
CTAs of one element swap their slices of each conv operand through global
memory and meet at a counter there, twice a step. Each streams its slice
of the weights from L2 through a ring of 16 KB stages (`pack_stream`:
mma.m16n8k16 fragment order); the state convs run on the tensor cores
(mma.sync, bf16 operands, f32 sums). The forward stores the gates u, r, c
(f32) when a backward will follow, so the recursion reads them and
recomputes nothing.

Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s) at B=28, T=42, U=256:
each direction's state convs are 2*T*B*49*9U*3U = 204 GFLOP (0.21 ms),
against 148 MB of wx and ys (44 us): operations bound it; phase W's weight
products are another 204 GFLOP.

Numerics rule (as `convgru.py`'s plain conv helpers): the state and
elementwise math in f32; every conv operand (h, r*h, the weights, and the
pre-activation gradients fed to the transposed convs and the weight
products) rounded to bf16, products summed in f32, the sums not rounded.
The plain versions here round the same way.

`kernel_takes` decides from the shapes, and takes only what is built and
tested: a 3x3 cell in bf16 with U a multiple of 128 up to 256 that B1
refuses (so every shape B1 or B5 takes keeps its kernel), on a grid whose
H x (W+2) rows fit the CTA's 64, within `SMEM_LIMIT`, and phase W's rule.
On a CUDA
tensor the wrappers launch the kernel or raise (no fallback), a batch
larger than the card holds at once in as many launches as it needs; on a
CPU tensor they run the plain versions `forward_plain` and
`backward_plain`. `launches` counts every launch of B6 (forward or
backward), `bwd_launches` the backward's. The wrapper's forward counts its
T steps in `recurrence.kernel_steps`; the plain forward, as any plain
scan, in `recurrence.plain_steps`.
"""

from __future__ import annotations

import threading

import torch

from ..cells import ConvGRU
from ...train.profiler import count
from ...utils import mfu
from . import build, convgru, convgru_vjp
from .convgru import (SMEM_LIMIT, align128, conv3x3, conv3x3_transpose,
                      hprev_of, mode_of, transposed_weight)

# Launches in this process: of B6 (forward or backward), and of its
# backward alone
launches = 0
bwd_launches = 0
_count_lock = threading.Lock()

# csrc/convgru_grid.cu's constants: the CTA's threads (8 warps: 4 along
# the channels by 2 along the rows), the output channels a CTA owns, its
# output rows, the weight ring's stages and their bytes
THREADS = 256
SLICE = 64
ROWS = 64
STAGES = 4
STAGE_BYTES = 16384
# the widths that are built and tested: U a multiple of 128 up to this
MAX_UNITS = 256


def pad_bytes(h: int, w: int, units: int) -> int:
    """Bytes of one padded conv operand: ROWS + 2 (W+2) + 2 rows of U + 8
    bf16."""
    return align128((ROWS + 2 * (w + 2) + 2) * (units + 8) * 2)


def smem_bytes(h: int, w: int, units: int, pads: int) -> int:
    """Shared memory of one CTA, as `csrc/convgru_grid.cu` lays it out: the
    weight ring, `pads` padded operands (the forward 1, the backward 2),
    the ring's barriers."""
    return STAGES * STAGE_BYTES + pads * pad_bytes(h, w, units) + 16 * STAGES


def kernel_takes(h: int, w: int, units: int, dtype: torch.dtype,
                 kernel: tuple[int, int] = (3, 3)) -> bool:
    """Whether kernel B6 takes a cell of U units with `kernel`-sized state
    convs on an H x W grid, wx in `dtype`: 3x3, bf16, U a multiple of 128
    up to MAX_UNITS that B1 refuses (`convgru.kernel_takes`), H*(W+2) <=
    ROWS, the backward's shared memory within SMEM_LIMIT and phase W's
    rule. A pure function of the shapes."""
    return (tuple(kernel) == (3, 3) and dtype == torch.bfloat16
            and units in range(128, MAX_UNITS + 1, 128) and h >= 1 and w >= 1
            and h * (w + 2) <= ROWS
            and smem_bytes(h, w, units, 2) <= SMEM_LIMIT
            and convgru_vjp.wgrad_takes(h, w, units, 2)
            and not convgru.kernel_takes(h, w, units, dtype, kernel))


def flops(t: int, b: int, h: int, w: int, units: int) -> int:
    """The contractions of one launch, either direction: T*B*H*W*9U*3U*2."""
    return convgru.flops(t, b, h, w, units, 3)


# ----------------------------------------------------------- weight stream

def fragments(b: torch.Tensor) -> torch.Tensor:
    """[K, N] (K, N multiples of 16 and 8) -> [K/16, N/8, 32, 4]: for
    k-step s and 8-column tile j, lane 4g + c holds the mma.m16n8k16 B
    fragment B[16s+2c+{0,1}][8j+g], B[16s+2c+8+{0,1}][8j+g]."""
    k, n = b.shape
    parts = b.reshape(k // 16, 2, 4, 2, n // 8, 8)  # s, half, c, kp, j, g
    return parts.permute(0, 4, 5, 2, 1, 3).reshape(k // 16, n // 8, 32, 4)


def pack_stream(w1: torch.Tensor, w2: torch.Tensor, w3: torch.Tensor
                ) -> torch.Tensor:
    """Three [3,3,U,U] kernels as the CTAs stream them, bf16 [U/64, 54*U/256
    stages of STAGE_BYTES]: for the CTA of channel slice s (columns
    [64s, 64s+64), 8 a warp), phase 1's stages (four k-steps each: per
    k-step, warp and lane, w1's then w2's fragment of the warp's tile),
    then phase 2's (four k-step pairs each: w3's fragments of two
    k-steps)."""
    units = w1.shape[-1]
    slices, ks = units // SLICE, 9 * units // 16

    def frags(w):  # -> [slices, ks, 8 warps, 32, 4]
        f = fragments(w.to(torch.bfloat16).reshape(9 * units, units))
        return f.reshape(ks, slices, 8, 32, 4).transpose(0, 1)

    phase1 = torch.cat([frags(w1), frags(w2)], dim=-1)
    phase2 = (frags(w3).reshape(slices, ks // 2, 2, 8, 32, 4)
              .permute(0, 1, 3, 4, 2, 5))
    return torch.cat([phase1.reshape(slices, -1), phase2.reshape(slices, -1)],
                     dim=1).contiguous()


def forward_stream(uzr: torch.Tensor, uc: torch.Tensor) -> torch.Tensor:
    """The forward's stream: h -> [z|r] through U_z and U_r, r*h -> c
    through U_c."""
    units = uc.shape[-1]
    return pack_stream(uzr[..., :units], uzr[..., units:], uc)


def backward_stream(uzr: torch.Tensor, uc: torch.Tensor) -> torch.Tensor:
    """The recursion's stream, the transposed convs: da -> drh through U_c,
    du_pre -> dh through U_z, dr_pre -> dh through U_r."""
    units = uc.shape[-1]
    return pack_stream(transposed_weight(uc),
                       transposed_weight(uzr[..., :units]),
                       transposed_weight(uzr[..., units:]))


# ------------------------------------------------------------ plain versions

def forward_plain(uzr: torch.Tensor, uc: torch.Tensor, wx: torch.Tensor,
                  h0: torch.Tensor, keep_gates: bool = False):
    """The plain version of the forward kernel, step by step as
    `ConvGRU.scan_precomputed`: wx [T,B,H,W,3U], h0 [B,H,W,U] -> (ys
    [T,B,H,W,U], the gates [3,T,B,H,W,U] = u, r, c or None), f32, the
    convs' operands rounded to wx's dtype. A plain scan on the host: counts
    its T steps in `recurrence.plain_steps`."""
    cdt = mode_of(wx)
    units = uc.shape[-1]
    count("recurrence.plain_steps", len(wx))
    h = h0.float()
    ys, gates = [], []
    for x in wx:
        x = x.float()
        zr = conv3x3(h, uzr, cdt)
        u = torch.sigmoid(x[..., :units] + zr[..., :units])
        r = torch.sigmoid(x[..., units:2 * units] + zr[..., units:])
        c = torch.tanh(x[..., 2 * units:] + conv3x3(r * h, uc, cdt))
        h = u * h + (1.0 - u) * c
        ys.append(h)
        if keep_gates:
            gates.append(torch.stack([u, r, c]))
    return torch.stack(ys), (torch.stack(gates, 1) if keep_gates else None)


def backward_plain(uzr, uc, h0, ys, gates, g, compute_dtype=None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the backward kernel, its reverse-time recursion
    on the forward's gates [3,T,B,H,W,U] -> (dwx [T,B,H,W,3U], dh0), f32;
    the conv operands rounded to `compute_dtype`."""
    units = uc.shape[-1]
    hprev = hprev_of(h0, ys)
    dh = torch.zeros_like(hprev[0])
    dwx = []
    for t in reversed(range(len(ys))):
        h, (u, r, c) = hprev[t], gates[:, t].float()
        dh_new = g[t].float() + dh
        du_pre = dh_new * (h - c) * u * (1.0 - u)
        da = dh_new * (1.0 - u) * (1.0 - c * c)
        drh = conv3x3_transpose(da, uc, compute_dtype)
        dr_pre = drh * h * r * (1.0 - r)
        dh = (dh_new * u + drh * r
              + conv3x3_transpose(du_pre, uzr[..., :units], compute_dtype)
              + conv3x3_transpose(dr_pre, uzr[..., units:], compute_dtype))
        dwx.append(torch.cat([du_pre, dr_pre, da], dim=-1))
    return torch.stack(dwx[::-1]), dh


# ------------------------------------------------------------------ launches

def _check(uzr, uc, wx, h0) -> tuple[int, ...]:
    """(T, B, H, W, U) of a call the kernel takes; raises otherwise."""
    if wx.dim() != 5 or h0.dim() != 4 or uzr.dim() != 4:
        raise ValueError(f"need wx [T,B,H,W,3U], h0 [B,H,W,U] and U_zr "
                         f"[3,3,U,2U]; got {tuple(wx.shape)}, "
                         f"{tuple(h0.shape)} and {tuple(uzr.shape)}")
    t, b, hh, ww, three_u = wx.shape
    units = three_u // 3
    k = tuple(uzr.shape[:2])
    if (three_u != 3 * units or t < 1 or b < 1
            or tuple(h0.shape) != (b, hh, ww, units)
            or tuple(uzr.shape) != (*k, units, 2 * units)
            or tuple(uc.shape) != (*k, units, units)
            or not kernel_takes(hh, ww, units, wx.dtype, k)):
        raise ValueError(
            f"convgru_grid takes wx [T>=1,B>=1,H,W,3U] in bf16 with U a "
            f"multiple of 128 up to {MAX_UNITS} that convgru_fwd refuses and "
            f"H*(W+2) <= {ROWS}, h0 [B,H,W,U], U_zr [3,3,U,2U] and U_c "
            f"[3,3,U,U]; got wx {tuple(wx.shape)} {wx.dtype}, h0 "
            f"{tuple(h0.shape)}, U_zr {tuple(uzr.shape)}, U_c "
            f"{tuple(uc.shape)}")
    return t, b, hh, ww, units


_max_batch: dict = {}


def max_batch(h: int, w: int, units: int, backward: bool,
              device: torch.device) -> int:
    """Batch elements one cooperative launch takes: the CTAs the card
    holds at once (1 a SM) over U/64 CTAs an element."""
    key = (h, w, units, backward, device.index)
    if key not in _max_batch:
        with torch.cuda.device(device):
            ctas = build.load().convgru_grid_max_ctas(h, w, units,
                                                      int(backward))
        if ctas < units // SLICE:
            raise RuntimeError(f"convgru_grid: the card holds {ctas} CTAs "
                               f"at once at H={h} W={w} U={units}")
        _max_batch[key] = ctas // (units // SLICE)
    return _max_batch[key]


def _chunks(b: int, most: int) -> list[slice]:
    return [slice(i, min(b, i + most)) for i in range(0, b, most)]


def _launch_fwd(uzr, uc, wx, h0, keep_gates: bool):
    global launches
    t, b, hh, ww, units = _check(uzr, uc, wx, h0)
    device = build.same_device("convgru_grid_fwd", uzr, uc, wx, h0)
    count("recurrence.kernel_steps", t)
    stream = forward_stream(uzr, uc)
    f32 = dict(dtype=torch.float32, device=device)
    ys = torch.empty((t, b, hh, ww, units), **f32)
    gates = (torch.empty((3, t, b, hh, ww, units), **f32) if keep_gates
             else None)
    for part in _chunks(b, max_batch(hh, ww, units, False, device)):
        n = part.stop - part.start
        x = wx[:, part].contiguous()
        h = h0[part].float().contiguous()
        y = ys[:, part] if n == b else torch.empty_like(ys[:, part])
        gt = (None if gates is None else gates[:, :, part] if n == b
              else torch.empty_like(gates[:, :, part]))
        exch = torch.empty((2, n, hh, ww, units), dtype=torch.bfloat16,
                           device=device)
        ctr = torch.zeros(n, dtype=torch.int32, device=device)
        build.launch("convgru_grid_fwd", device, x.data_ptr(),
                     stream.data_ptr(), h.data_ptr(), y.data_ptr(),
                     None if gt is None else gt.data_ptr(), exch[0].data_ptr(),
                     exch[1].data_ptr(), ctr.data_ptr(), t, n, hh, ww, units)
        if n != b:
            ys[:, part] = y
            if gates is not None:
                gates[:, :, part] = gt
        with _count_lock:
            launches += 1
        mfu.add_kernel_flops("convgru_grid_fwd", flops(t, n, hh, ww, units))
    return ys, gates


def _launch_bwd(uzr, uc, wx, h0, ys, gates, g
                ) -> tuple[torch.Tensor, torch.Tensor]:
    global launches, bwd_launches
    t, b, hh, ww, units = _check(uzr, uc, wx, h0)
    shape = (t, b, hh, ww, units)
    if (tuple(ys.shape) != shape or tuple(g.shape) != shape
            or gates is None or tuple(gates.shape) != (3, *shape)):
        raise ValueError(f"convgru_grid backward needs ys and g [T,B,H,W,U] "
                         f"= {shape} and the forward's gates [3,T,B,H,W,U]; "
                         f"got {tuple(ys.shape)}, {tuple(g.shape)} and "
                         f"{None if gates is None else tuple(gates.shape)}")
    device = build.same_device("convgru_grid_bwd", uzr, uc, wx, h0, ys, gates,
                               g)
    stream = backward_stream(uzr, uc)
    dwx = torch.empty((t, b, hh, ww, 3 * units), dtype=torch.bfloat16,
                      device=device)
    dh0 = torch.empty((b, hh, ww, units), dtype=torch.float32, device=device)
    most = max_batch(hh, ww, units, True, device)
    for part in _chunks(b, most):
        n = part.stop - part.start
        whole = n == b
        gt = (gates if whole else gates[:, :, part]).float().contiguous()
        y = (ys if whole else ys[:, part]).float().contiguous()
        h = h0[part].float().contiguous()
        gy = (g if whole else g[:, part]).float().contiguous()
        d = dwx if whole else torch.empty_like(dwx[:, part])
        d0 = dh0 if whole else torch.empty_like(dh0[part])
        exch = torch.empty((3, n, hh, ww, units), dtype=torch.bfloat16,
                           device=device)
        ctr = torch.zeros(n, dtype=torch.int32, device=device)
        build.launch("convgru_grid_bwd", device, stream.data_ptr(),
                     gt.data_ptr(), y.data_ptr(), h.data_ptr(), gy.data_ptr(),
                     d.data_ptr(), d0.data_ptr(), exch[0].data_ptr(),
                     exch[1].data_ptr(), exch[2].data_ptr(), ctr.data_ptr(),
                     t, n, hh, ww, units)
        if not whole:
            dwx[:, part], dh0[part] = d, d0
        with _count_lock:
            launches += 1
            bwd_launches += 1
        mfu.add_kernel_flops("convgru_grid_bwd", flops(t, n, hh, ww, units))
    return dwx, dh0


def recurrence(uzr, uc, wx, h0, keep_gates: bool = False):
    """(ys [T,B,H,W,U] f32, the gates [3,T,B,H,W,U] or None) from wx
    [T,B,H,W,3U] and h0: kernel B6 on a CUDA tensor, `forward_plain` on a
    CPU tensor."""
    if wx.device.type == "cuda":
        return _launch_fwd(uzr, uc, wx, h0, keep_gates)
    if wx.device.type != "cpu":
        raise ValueError(f"no grid ConvGRU kernel for device {wx.device}")
    return forward_plain(uzr, uc, wx, h0, keep_gates)


def recurrence_bwd(uzr, uc, wx, h0, ys, gates, g
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The recursion: (dwx in wx's dtype, dh0): kernel B6's backward on a
    CUDA tensor, `backward_plain` on a CPU tensor."""
    if wx.device.type == "cuda":
        return _launch_bwd(uzr, uc, wx, h0, ys, gates, g)
    if wx.device.type != "cpu":
        raise ValueError(f"no grid ConvGRU kernel for device {wx.device}")
    dwx, dh0 = backward_plain(uzr, uc, h0, ys, gates, g, mode_of(wx))
    return dwx.to(wx.dtype), dh0


def backward(uzr, uc, wx, h0, ys, gates, g) -> tuple[torch.Tensor, ...]:
    """The whole backward: the recursion, then phase W's weight products
    over every frame from h_{t-1}, r*h_{t-1} and dwx -> (dwx in wx's dtype,
    dh0, dU_zr, dU_c)."""
    units = uc.shape[-1]
    dwx, dh0 = recurrence_bwd(uzr, uc, wx, h0, ys, gates, g)
    hprev = hprev_of(h0, ys)
    duzr, duc = convgru_vjp.wgrad(hprev, dwx[..., :2 * units],
                                  gates[1].float() * hprev,
                                  dwx[..., 2 * units:], mode_of(wx))
    return dwx, dh0, duzr, duc


class ConvGRUGrid(torch.autograd.Function):
    """The differentiable recurrence over precomputed gates: (U_zr, U_c,
    wx, h0) -> ys, the forward one launch of B6, the backward one launch of
    its recursion and phase W. Saves its inputs, ys and (when a backward
    will follow: `keep_gates`) the gates."""

    @staticmethod
    def forward(ctx, uzr, uc, wx, h0, keep_gates):
        ys, gates = recurrence(uzr, uc, wx, h0, keep_gates)
        ctx.save_for_backward(uzr, uc, wx, h0, ys, gates)
        return ys

    @staticmethod
    def backward(ctx, g):
        uzr, uc, wx, h0, ys, gates = ctx.saved_tensors
        dwx, dh0, duzr, duc = backward(uzr, uc, wx, h0, ys, gates, g)
        return (duzr.to(uzr.dtype), duc.to(uc.dtype), dwx, dh0.to(h0.dtype),
                None)


def convgru_scan_grid(params, x_tbhwc: torch.Tensor, h0: torch.Tensor,
                      compute_dtype=torch.bfloat16
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for `ConvGRU.scan` on the cells B6 takes: the input-side
    conv over all T*B frames stays one library conv, differentiated by
    autograd; the recurrence is `ConvGRUGrid`. Returns (ys[-1], ys)."""
    fused = ConvGRU.fuse(params)
    wx_all = ConvGRU.input_gates(fused, x_tbhwc, compute_dtype)
    inputs = (fused["Uh_zr"], fused["U_c"], wx_all, h0)
    keep = torch.is_grad_enabled() and any(x.requires_grad for x in inputs)
    ys = ConvGRUGrid.apply(*inputs[:3], h0.float(), keep)
    return ys[-1], ys
