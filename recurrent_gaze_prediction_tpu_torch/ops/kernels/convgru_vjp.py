"""ConvGRU custom backward: kernel B4's phases G and W (wrappers and plain
versions), B4's wrapper over G, B2 and W, and the one autograd Function
that trains the recurrence through the same three kernels.

Replaces the TPU kernel `_convgru_bwd_kernel` of the JAX package's
`ops/pallas/convgru_vjp.py` (`_convgru_bwd_pallas`, custom VJP
`convgru_scan_fused`, entry point `convgru_scan_trainable`) and the custom
VJP `convgru_fused` of its `ops/pallas/convgru_vjp2.py` (entry point
`convgru_scan_trainable_v2`). That kernel walks T in reverse and, per step,
recomputes the gates from h_{t-1}, forms both transposed convs and
accumulates dU_zr and dU_c. Only the cotangent recursion is serial, so on
the card the backward is three launches on one stream
(`convgru_bwd_phased`):

  phase G (`csrc/convgru_bwd_gates.cu`, `bwd_gates`): u, r, c, h_{t-1} and
      r*h_{t-1} for all T*B frames at once (the recompute reads only wx and
      h_{t-1} = [h0, ys[:-1]]); in bf16 wgmma with the weights streamed
      through a TMA ring, two frames per CTA;
  B2 (`csrc/convgru_bwd.cu`, `convgru_vjp2.dh_bwd`): the reverse-time
      recursion -> dzr = [du_pre|dr_pre], da, dh0;
  phase W (`csrc/convgru_wgrad.cu`, `wgrad`): dU_zr = sum patches(h)^T
      dzr and dU_c = sum patches(r*h)^T da as one split-K implicit GEMM
      with a deterministic sum of the slices; in bf16 wgmma on tiles that
      share one staged frame across all nine taps;

and dwx = [dzr|da] is one concatenation (a copy, no arithmetic). Both JAX
entry points run the one Function, `ConvGRUFused` (forward B1, backward G,
B2 and W). B4's wrapper `convgru_bwd`, the same three kernels outside
autograd, stands for `_convgru_bwd_pallas` in the parity checks.

Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s) at T=42, U=128 in bf16:
operations, each phase 14.57 / 29.13 / 50.98 GFLOP at B=8 / 16 / 28,
43.70 / 87.40 / 152.9 in all (44.2 / 88.4 / 154.6 us); phase G alone is
bound by its bytes (19 / 38 / 67 us).

Numerics rule (as in the forward kernel): all elementwise math is f32; in
bf16 mode (wx in bf16) every conv and weight-gradient operand is rounded to
bf16 and the products are summed in f32; in f32 mode everything is f32.
Phase G rounds h_{t-1} and r*h_{t-1} where the forward kernel did, so B2
sees the forward's gates. The plain versions here round the same way, so
the card's check compares like with like. The JAX kernel casts its weights
to f32 (`convgru_vjp.py:173`); on the TPU its f32 dots round their operands
to bf16 at default precision, which is the rule written out.

On a CUDA tensor G, B2 and W launch or raise (no fallback); `launches`
counts calls of `convgru_bwd`, `gates_launches` and `wgrad_launches` the
launches of G and W (`convgru_vjp2.launches` B2's). On a CPU tensor
`convgru_bwd` runs the step-by-step `convgru_bwd_plain`, the Function's
backward the phases' plain versions `recompute_gates`, `dh_bwd_plain` and
`wgrad_plain`.
"""

from __future__ import annotations

import threading

import torch

from ..cells import ConvGRU
from ...utils import mfu
from . import build
from .convgru import (_DTYPES, SMEM_LIMIT, align128, aligned, check_fits,
                      conv3x3, conv3x3_transpose, convgru_recurrence, flops,
                      hprev_of, kernel_grad, mode_of, pad_bytes)
from .convgru_vjp2 import dh_bwd
from .convgru_vjp2 import kernel_takes as b2_takes

# Launches in this process: of B4's wrapper, and of its phases G and W;
# chip_smoke.py resets them to 0 before driving a path and reads them after.
launches = 0
gates_launches = 0
wgrad_launches = 0
_count_lock = threading.Lock()


def convgru_bwd_plain(uzr: torch.Tensor, uc: torch.Tensor, wx: torch.Tensor,
                      ys: torch.Tensor, h0: torch.Tensor, g: torch.Tensor
                      ) -> tuple[torch.Tensor, ...]:
    """The plain version of the kernel, step by step as
    `_convgru_bwd_kernel`: -> (dwx [T,B,H,W,3U], dh0, dU_zr, dU_c), f32."""
    cdt = mode_of(wx)
    units = uc.shape[-1]
    hprev = hprev_of(h0, ys)
    wxf = wx.float()
    dh = torch.zeros_like(hprev[0])
    duzr = torch.zeros(uzr.shape, dtype=torch.float32, device=wx.device)
    duc = torch.zeros(uc.shape, dtype=torch.float32, device=wx.device)
    dwx = []
    for t in reversed(range(wx.shape[0])):
        h_prev, x = hprev[t], wxf[t]
        uh = conv3x3(h_prev, uzr, cdt)
        u = torch.sigmoid(x[..., :units] + uh[..., :units])
        r = torch.sigmoid(x[..., units:2 * units] + uh[..., units:])
        rh = r * h_prev
        c = torch.tanh(x[..., 2 * units:] + conv3x3(rh, uc, cdt))
        dh_new = g[t].float() + dh
        du_pre = dh_new * (h_prev - c) * u * (1.0 - u)
        da = dh_new * (1.0 - u) * (1.0 - c * c)
        drh = conv3x3_transpose(da, uc, cdt)
        duc = duc + kernel_grad(rh, da, cdt)
        dr_pre = drh * h_prev * r * (1.0 - r)
        dzr = torch.cat([du_pre, dr_pre], dim=-1)
        duzr = duzr + kernel_grad(h_prev, dzr, cdt)
        dh = dh_new * u + drh * r + conv3x3_transpose(dzr, uzr, cdt)
        dwx.append(torch.cat([du_pre, dr_pre, da], dim=-1))
    return torch.stack(dwx[::-1]), dh, duzr, duc


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


def wgrad_plain(hprev, dzr, rh, da, compute_dtype=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Phase W's plain version: (dU_zr, dU_c) = (kernel_grad(hprev, dzr),
    kernel_grad(rh, da)), summed over every frame, in f32."""
    return (kernel_grad(hprev, dzr, compute_dtype),
            kernel_grad(rh, da, compute_dtype))


def convgru_bwd_phased(uzr, uc, wx, ys, h0, g, *, gates, recursion, tail
                       ) -> tuple[torch.Tensor, ...]:
    """B4 as three phases: `gates(uzr, uc, wx, h0, ys)` -> u, r, c, hprev,
    rh; `recursion(u, r, c, hprev, g, uzr, uc, compute_dtype)` -> dzr, da,
    dh0; `tail(hprev, dzr, rh, da, compute_dtype)` -> dU_zr, dU_c. Returns
    (dwx = [dzr|da], dh0, dU_zr, dU_c) as `convgru_bwd_plain` does."""
    cdt = mode_of(wx)
    u, r, c, hprev, rh = gates(uzr, uc, wx, h0, ys)
    dzr, da, dh0 = recursion(u, r, c, hprev, g.float(), uzr, uc, cdt)
    duzr, duc = tail(hprev, dzr, rh, da, cdt)
    return torch.cat([dzr, da], dim=-1), dh0, duzr, duc


# Phase G's bf16 plan (csrc/convgru_bwd_gates.cu, `make_ggeo`): K chunks
# of 64 bf16 weights (128-byte rows) through a ring of at most 4 stages
GATES_CHUNK, GATES_MAX_STAGES = 64, 4


def n_tile(columns: int) -> int:
    """The N tile of one of phase G's convs (a wgmma width): the widest of
    128, 64, 32 and 16 that divides `columns`."""
    bn = 128
    while columns % bn:
        bn //= 2
    return bn


def gates_plan(h: int, w: int, units: int) -> dict:
    """Phase G's bf16 plan, as `make_ggeo` reckons it: the N tiles of the
    two convs, frame buffers per warpgroup (1 when r*h overwrites h in
    place: one 64-row M tile per frame and the r columns in the first
    conv's last N tile), bytes of a frame buffer and of a frame's h (f32)
    and wx (bf16) staged, and the weight ring's depth (as many stages of
    the widest tile as fit, 2..4)."""
    wp = w + 2
    m_tiles = -(-h * wp // 64)
    bn1 = n_tile(2 * units)
    nbuf = 1 if m_tiles == 1 and bn1 >= units else 2
    padb = align128((64 * m_tiles + 2 * wp + 2) * (units + 8) * 2)
    hsb, wxb = align128(h * w * units * 4), align128(h * w * 3 * units * 2)
    fixed = 1024 + 2 * (nbuf * padb + hsb + wxb) + 64
    stages = (SMEM_LIMIT - fixed) // (128 * bn1 + 16)
    return dict(bn1=bn1, bn2=n_tile(units), nbuf=nbuf, padb=padb, hsb=hsb,
                wxb=wxb, stages=min(GATES_MAX_STAGES, max(2, stages)))


def gates_smem_bytes(h: int, w: int, units: int, elem: int) -> int:
    """Shared memory of one CTA of phase G, as `csrc/convgru_bwd_gates.cu`
    lays it out: in bf16 the 1024-byte alignment slack, the weight ring,
    two frames' padded buffers, staged h and staged wx, and the barriers;
    in f32 hpad and rhpad of one frame."""
    if elem == 4:
        return 2 * pad_bytes(h, w, units, 4)
    p = gates_plan(h, w, units)
    return (1024 + p["stages"] * 128 * p["bn1"]
            + 2 * (p["nbuf"] * p["padb"] + p["hsb"] + p["wxb"])
            + 16 * p["stages"] + 64)


def kernel_takes(h: int, w: int, units: int, dtype: torch.dtype,
                 kernel: tuple[int, int] = (3, 3)) -> bool:
    """Whether B4 takes U units on an H x W grid in `dtype` (wx's): when B2
    takes it (`convgru_vjp2.kernel_takes`) and phases G and W fit. This is
    also the rule of `ConvGRUFused`'s backward, which runs the same three
    kernels."""
    elem = _DTYPES.get(dtype)
    return (b2_takes(h, w, units, dtype, kernel)
            and gates_smem_bytes(h, w, units, elem) <= SMEM_LIMIT
            and wgrad_takes(h, w, units, elem))


# Phase W's plan (csrc/convgru_wgrad.cu). bf16: tiles of 64 input channels
# (all nine taps) by 64 output columns, one CTA per SM; f32: 128 x 128
# single-tap tiles, two CTAs per SM. The split-K slices fill the card's
# slots, a function of the shapes alone.
WGRAD_BLOCK, WGRAD_STAGES, WGRAD_SLOTS = 64, 3, 132
WGRAD_F32_TILE, WGRAD_F32_CHUNK, WGRAD_F32_SLOTS = 128, 32, 264


def wgrad_grid(h: int, w: int) -> tuple[int, int, int]:
    """(RS, P, XR) of phase W's bf16 K grid: positions per row (W + 1
    rounded up to 8, so a row shift is whole swizzle atoms), K rows per
    frame ((H + 1) rows, rounded up to 16), rows of a shifted input copy
    (P and a zero block of RS rows above and below)."""
    rs = -(-(w + 1) // 8) * 8
    p = -(-(h + 1) * rs // 16) * 16
    return rs, p, p + 2 * rs


def wgrad_tiles(h: int, w: int, units: int, elem: int) -> int:
    """Output tiles of phase W: in bf16 channel blocks x (column blocks of
    dU_zr [.., 2U] + of dU_c [.., U]), blocks of 64; in f32 128 x 128
    tiles of dU_zr [9U, 2U] and dU_c [9U, U]."""
    if elem == 2:
        def blocks(n):
            return -(-n // WGRAD_BLOCK)
        return blocks(units) * (blocks(2 * units) + blocks(units))
    rows = -(-9 * units // WGRAD_F32_TILE)
    return rows * (-(-2 * units // WGRAD_F32_TILE)
                   + -(-units // WGRAD_F32_TILE))


def wgrad_slices(frames: int, h: int, w: int, units: int, elem: int) -> int:
    """Phase W's split of K: as many slices as fill the card's slots with
    the tiles, in bf16 no more than the frames (a slice is whole frames),
    in f32 no more than the K chunks of 32 positions."""
    limit = (frames if elem == 2
             else -(-frames * h * w // WGRAD_F32_CHUNK))
    slots = WGRAD_SLOTS if elem == 2 else WGRAD_F32_SLOTS
    return max(1, min(limit, slots // wgrad_tiles(h, w, units, elem)))


def wgrad_smem_bytes(h: int, w: int, units: int, elem: int) -> int:
    """Shared memory of one CTA of phase W: in bf16 the alignment slack,
    two operand buffers (three shifted input copies and the cotangent tile
    in 128-byte rows), the f32 ring of input and cotangent boxes and its
    barriers; in f32 two stages of 32-row A and B chunks."""
    if elem == 4:
        return 2 * 2 * WGRAD_F32_CHUNK * (WGRAD_F32_TILE + 4) * 4
    _, p, xr = wgrad_grid(h, w)
    return (1024 + 2 * (3 * xr + p) * 128
            + WGRAD_STAGES * 2 * h * w * WGRAD_BLOCK * 4 + 8 * WGRAD_STAGES)


def wgrad_takes(h: int, w: int, units: int, elem: int) -> bool:
    """Whether phase W takes the shapes: every U that is a multiple of 16;
    in bf16 a frame must fit one TMA box (H*W <= 256) and the buffers
    shared memory."""
    if units < 16 or units % 16:
        return False
    return elem == 4 or (h * w <= 256 and wgrad_smem_bytes(h, w, units, 2)
                         <= SMEM_LIMIT)


def gates_weight(kernel: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A [3,3,U,N] weight as phase G reads it: in bf16 [N][9U], each
    output column's K = (dy, dx, cin) contiguous (the K-major tile TMA
    brings); in f32 the plain [9U][N]."""
    units, n = kernel.shape[2], kernel.shape[3]
    flat = kernel.to(dtype).reshape(9 * units, n)
    return aligned((flat.t() if dtype == torch.bfloat16 else flat)
                   .contiguous())


def _launch_gates(uzr, uc, wx, h0, ys) -> tuple[torch.Tensor, ...]:
    global gates_launches
    if wx.dim() != 5:
        raise ValueError(f"need wx [T,B,H,W,3U]; got {tuple(wx.shape)}")
    t, b, hh, ww, three_u = wx.shape
    units = three_u // 3
    if wx.dtype not in _DTYPES:
        raise ValueError(f"wx dtype must be bfloat16 or float32, got "
                         f"{wx.dtype}")
    if (three_u != 3 * units or units < 16 or units % 16
            or tuple(ys.shape) != (t, b, hh, ww, units)
            or tuple(h0.shape) != (b, hh, ww, units)
            or tuple(uzr.shape) != (3, 3, units, 2 * units)
            or tuple(uc.shape) != (3, 3, units, units)):
        raise ValueError(
            f"convgru_bwd_gates takes wx [T,B,H,W,3U] with U a multiple of "
            f"16, ys [T,B,H,W,U], h0 [B,H,W,U], U_zr [3,3,U,2U], U_c "
            f"[3,3,U,U]; got wx {tuple(wx.shape)}, ys {tuple(ys.shape)}, h0 "
            f"{tuple(h0.shape)}, U_zr {tuple(uzr.shape)}, U_c "
            f"{tuple(uc.shape)}")
    device = build.same_device("convgru_bwd_gates", uzr, uc, wx, h0, ys)
    elem = _DTYPES[wx.dtype]
    check_fits("convgru_bwd_gates", gates_smem_bytes(hh, ww, units, elem),
               hh, ww, units)
    wx = aligned(wx.contiguous())
    h0 = aligned(h0.float().contiguous())
    ys = aligned(ys.float().contiguous())
    wzr, wc = (gates_weight(k, wx.dtype) for k in (uzr, uc))
    outs = [torch.empty((t, b, hh, ww, units), dtype=torch.float32,
                        device=device) for _ in range(5)]
    build.launch("convgru_bwd_gates", device, wx.data_ptr(), h0.data_ptr(),
                 ys.data_ptr(), wzr.data_ptr(), wc.data_ptr(),
                 *(x.data_ptr() for x in outs), t, b, hh, ww, units, elem)
    with _count_lock:
        gates_launches += 1
    mfu.add_kernel_flops("convgru_bwd_gates", flops(t, b, hh, ww, units, 3))
    return tuple(outs)


def bwd_gates(uzr, uc, wx, h0, ys) -> tuple[torch.Tensor, ...]:
    """Phase G: u, r, c, h_{t-1} and r*h_{t-1} [T,B,H,W,U] in f32 for every
    frame, from the forward's wx (bf16 or f32), h0 and ys. On a CUDA tensor
    the kernel (or raises); on a CPU tensor its plain version,
    `recompute_gates`."""
    if wx.device.type == "cuda":
        return _launch_gates(uzr, uc, wx, h0, ys)
    if wx.device.type != "cpu":
        raise ValueError(f"no ConvGRU gate kernel for device {wx.device}")
    return recompute_gates(uzr, uc, wx, h0, ys)


def _launch_wgrad(hprev, dzr, rh, da, compute_dtype
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    global wgrad_launches
    wdt = torch.float32 if compute_dtype is None else compute_dtype
    if wdt not in _DTYPES:
        raise ValueError(f"compute dtype must be bfloat16 or float32 (None), "
                         f"got {compute_dtype}")
    if hprev.dim() < 3:
        raise ValueError(f"need hprev [...,H,W,U]; got {tuple(hprev.shape)}")
    hh, ww, units = hprev.shape[-3:]
    frames = hprev.numel() // (hh * ww * units) if hprev.numel() else 0
    if (units < 16 or units % 16 or frames < 1
            or rh.shape != hprev.shape or da.shape != hprev.shape
            or tuple(dzr.shape) != (*hprev.shape[:-1], 2 * units)):
        raise ValueError(
            f"convgru_wgrad takes hprev, rh, da [...,H,W,U] with U a multiple "
            f"of 16 and dzr [...,H,W,2U]; got hprev {tuple(hprev.shape)}, "
            f"dzr {tuple(dzr.shape)}, rh {tuple(rh.shape)}, da "
            f"{tuple(da.shape)}")
    device = build.same_device("convgru_wgrad", hprev, dzr, rh, da)
    elem = _DTYPES[wdt]
    if not wgrad_takes(hh, ww, units, elem):
        raise ValueError(f"convgru_wgrad does not take H={hh} W={ww} "
                         f"U={units} in {wdt}: a frame must fit one TMA box "
                         f"(H*W <= 256) and its buffers shared memory")
    slices = wgrad_slices(frames, hh, ww, units, elem)
    ins = [aligned(x.float().contiguous()) for x in (hprev, dzr, rh, da)]
    f32 = dict(dtype=torch.float32, device=device)
    workspace = torch.empty(slices * 27 * units * units, **f32)
    out = torch.empty(27 * units * units, **f32)
    build.launch("convgru_wgrad", device, *(x.data_ptr() for x in ins),
                 workspace.data_ptr(), out.data_ptr(), frames, slices, hh,
                 ww, units, elem)
    with _count_lock:
        wgrad_launches += 1
    mfu.add_kernel_flops("convgru_wgrad", flops(frames, 1, hh, ww, units, 3))
    split = 18 * units * units
    return (out[:split].view(3, 3, units, 2 * units),
            out[split:].view(3, 3, units, units))


def wgrad(hprev, dzr, rh, da, compute_dtype=None
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Phase W: (dU_zr, dU_c) in f32, summed over every frame, from the
    h_{t-1} and r*h_{t-1} streams and the cotangents dzr and da.
    `compute_dtype` (None = f32) is the dtype the operands round to. On a
    CUDA tensor the kernel (or raises); on a CPU tensor `wgrad_plain`."""
    if hprev.device.type == "cuda":
        return _launch_wgrad(hprev, dzr, rh, da, compute_dtype)
    if hprev.device.type != "cpu":
        raise ValueError(f"no ConvGRU weight-gradient kernel for device "
                         f"{hprev.device}")
    return wgrad_plain(hprev, dzr, rh, da, compute_dtype)


def _launch(uzr: torch.Tensor, uc: torch.Tensor, wx: torch.Tensor,
            ys: torch.Tensor, h0: torch.Tensor, g: torch.Tensor
            ) -> tuple[torch.Tensor, ...]:
    global launches
    if wx.dim() != 5:
        raise ValueError(f"need wx [T,B,H,W,3U]; got {tuple(wx.shape)}")
    t, b, hh, ww, three_u = wx.shape
    units = three_u // 3
    if wx.dtype not in _DTYPES:
        raise ValueError(f"wx dtype must be bfloat16 or float32, got "
                         f"{wx.dtype}")
    if (three_u != 3 * units or units % 16 or t < 1 or b < 1
            or tuple(ys.shape) != (t, b, hh, ww, units)
            or tuple(g.shape) != (t, b, hh, ww, units)
            or tuple(h0.shape) != (b, hh, ww, units)
            or tuple(uzr.shape) != (3, 3, units, 2 * units)
            or tuple(uc.shape) != (3, 3, units, units)):
        raise ValueError(
            f"convgru_bwd_mono takes wx [T>=1,B>=1,H,W,3U] with U a "
            f"multiple of 16, ys and g [T,B,H,W,U], h0 [B,H,W,U], U_zr "
            f"[3,3,U,2U], U_c [3,3,U,U]; got wx {tuple(wx.shape)}, ys "
            f"{tuple(ys.shape)}, g {tuple(g.shape)}, h0 {tuple(h0.shape)}, "
            f"U_zr {tuple(uzr.shape)}, U_c {tuple(uc.shape)}")
    build.same_device("convgru_bwd_mono", uzr, uc, wx, ys, h0, g)
    if not kernel_takes(hh, ww, units, wx.dtype):
        raise ValueError(f"convgru_bwd_mono: phase G's or B2's shared memory "
                         f"does not fit at H={hh} W={ww} U={units} "
                         f"({wx.dtype})")
    out = convgru_bwd_phased(uzr, uc, wx, ys, h0, g, gates=bwd_gates,
                             recursion=dh_bwd, tail=wgrad)
    with _count_lock:
        launches += 1
    return out


def convgru_bwd(uzr: torch.Tensor, uc: torch.Tensor, wx: torch.Tensor,
                ys: torch.Tensor, h0: torch.Tensor, g: torch.Tensor
                ) -> tuple[torch.Tensor, ...]:
    """The whole backward of the recurrence (`_convgru_bwd_pallas`): from
    the fused state kernels, wx [T,B,H,W,3U] (bf16 or f32), the forward's
    ys, h0 and the cotangent g of ys -> (dwx, dh0, dU_zr, dU_c) in f32."""
    if wx.device.type == "cuda":
        return _launch(uzr, uc, wx, ys, h0, g)
    if wx.device.type != "cpu":
        raise ValueError(f"no ConvGRU backward kernel for device "
                         f"{wx.device}")
    return convgru_bwd_plain(uzr, uc, wx, ys, h0, g)


class ConvGRUFused(torch.autograd.Function):
    """The differentiable recurrence over precomputed gates, the port of
    `convgru_scan_fused` and `convgru_fused`: forward is kernel B1
    (`convgru_recurrence`), backward phase G, B2 and phase W. Saves only ys
    (the gates are recomputed), like the JAX custom VJPs."""

    @staticmethod
    def forward(ctx, uzr, uc, wx, h0):
        _, ys = convgru_recurrence({"Uh_zr": uzr, "U_c": uc}, wx, h0)
        ctx.save_for_backward(uzr, uc, wx, h0, ys)
        return ys

    @staticmethod
    def backward(ctx, g):
        uzr, uc, wx, h0, ys = ctx.saved_tensors
        # on a CPU tensor the phases' plain versions; dwx = [dzr|da]
        dwx, dh0, duzr, duc = convgru_bwd_phased(
            uzr, uc, wx, ys, h0, g, gates=bwd_gates, recursion=dh_bwd,
            tail=wgrad)
        return (duzr.to(uzr.dtype), duc.to(uc.dtype), dwx.to(wx.dtype),
                dh0.to(h0.dtype))


def convgru_scan_trainable(params, x_tbhwc: torch.Tensor, h0: torch.Tensor,
                           compute_dtype=torch.bfloat16
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for `ConvGRU.scan` with the kernels forward and backward
    (`ConvGRUFused`). The input-side conv stays one library conv,
    differentiated by autograd. Returns (ys[-1], ys)."""
    fused = ConvGRU.fuse(params)
    wx_all = ConvGRU.input_gates(fused, x_tbhwc, compute_dtype)
    ys = ConvGRUFused.apply(fused["Uh_zr"], fused["U_c"], wx_all, h0.float())
    return ys[-1], ys


# The JAX package's two entry points differ in how their backward is split;
# here both run `ConvGRUFused`.
convgru_scan_trainable_v2 = convgru_scan_trainable
