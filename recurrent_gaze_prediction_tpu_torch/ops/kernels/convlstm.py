"""Peephole ConvLSTM recurrence: the hand-written CUDA kernel's wrapper.

Replaces the TPU kernel `_convlstm_seq_kernel` of the JAX package's
`ops/pallas/convlstm.py` (`convlstm_scan_pallas`, wrapper `convlstm_scan`).
The kernel (`csrc/convlstm_fwd.cu`) runs the whole recurrence over T in one
launch. Each batch element runs on a thread-block cluster of
`cluster_size(U)` CTAs (8 at U=128), as kernel B1 does: each CTA owns U/C
channels and the 4U/C output columns of their i, f, c and o gates, keeps
that column slice of Wh in shared memory for the whole sequence and its
channels of c in f32, and gathers the full h from its peers through
distributed shared memory into one of two buffers, so one cluster barrier
per step suffices; the state conv runs on the tensor cores in bf16. Unlike
the JAX wrapper, which drops the final cell state, it returns the final
(c, h), so the streaming step carries the state across chunks through the
kernel.

Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s) at T=42, U=128 in bf16:
operations, T*B*49*9*U*4U*2 = 19.4 GFLOP at B=8 (19.6 us) and 38.8 GFLOP at
B=16 (39.3 us), against gx + ys + Wh ~ 26.5 / 51.8 MB moved (7.9 / 15.5 us).
The recurrence is sequential in T, so a step's latency on one cluster is
what the design works on.

On a CUDA tensor the wrapper launches the kernel or raises (no fallback).
On a CPU tensor it runs the plain version, `ConvLSTM.scan_precomputed`,
which the tests and `chip_smoke.py` hold the kernel against.
"""

from __future__ import annotations

import threading

import torch

from ..cells import ConvLSTM
from ...utils import mfu
from . import build
from .convgru import (_DTYPES, acc_bytes, align128, aligned, check_fits,
                      cluster_kernel_takes, cluster_size, flops, pack_slices,
                      pad_bytes)

# Launches of the CUDA kernel in this process; chip_smoke.py resets it to
# 0 before driving a path and reads it after.
launches = 0
_count_lock = threading.Lock()

_PEEPHOLES = ("W_ci", "W_cf", "W_co")
GATES = 4     # i, f, c, o: a CTA's output columns are 4 Ns
K_GROUPS = 1  # planes of the conv's partial sums (a second does not fit)


def smem_bytes(h: int, w: int, units: int, elem: int) -> int:
    """Shared memory of one CTA of kernel B3, as `csrc/convlstm_fwd.cu`
    lays it out: the weight slice (bf16 only), two hpads (ping-pong), acc,
    own c, two gx slices."""
    ns = units // cluster_size(units)
    hw = h * w
    weights = align128(9 * units * GATES * ns * elem) if elem == 2 else 0
    return (weights + 2 * pad_bytes(h, w, units, elem)
            + acc_bytes(h, w, GATES * ns, elem, K_GROUPS)
            + align128(hw * ns * 4) + align128(2 * GATES * hw * ns * elem))


def kernel_takes(h: int, w: int, units: int, dtype: torch.dtype) -> bool:
    """Whether kernel B3 takes U units on an H x W grid in `dtype` (the
    dtype of gx), by `convgru.cluster_kernel_takes` with B3's
    `smem_bytes`."""
    return cluster_kernel_takes(smem_bytes, h, w, units, dtype)


def _check(fused: dict, gx: torch.Tensor, c0: torch.Tensor,
           h0: torch.Tensor) -> None:
    """Raise ValueError for shapes or dtypes the kernel does not take."""
    if gx.dim() != 5 or c0.dim() != 4 or h0.dim() != 4:
        raise ValueError(f"need gx [T,B,H,W,4U], c0 and h0 [B,H,W,U]; got "
                         f"{tuple(gx.shape)}, {tuple(c0.shape)} and "
                         f"{tuple(h0.shape)}")
    if gx.dtype not in _DTYPES:
        raise ValueError(f"gx dtype must be bfloat16 or float32, got "
                         f"{gx.dtype}")
    t, b, hh, ww, four_u = gx.shape
    units = four_u // 4
    shapes = {"c0": c0.shape, "h0": h0.shape, "Wh": fused["Wh"].shape,
              **{k: fused[k].shape for k in _PEEPHOLES}}
    want = {"c0": (b, hh, ww, units), "h0": (b, hh, ww, units),
            "Wh": (3, 3, units, four_u),
            **{k: (hh, ww, units) for k in _PEEPHOLES}}
    if (four_u != 4 * units or units < 1 or t < 1 or b < 1
            or any(tuple(shapes[k]) != want[k] for k in want)):
        raise ValueError(
            f"convlstm kernel takes gx [T>=1,B>=1,H,W,4U], c0 and h0 "
            f"[B,H,W,U], Wh [3,3,U,4U], peepholes [H,W,U]; got gx "
            f"{tuple(gx.shape)}, "
            + ", ".join(f"{k} {tuple(v)}" for k, v in shapes.items()))


def _launch(fused: dict, gx: torch.Tensor, c0: torch.Tensor,
            h0: torch.Tensor
            ) -> tuple[tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
    global launches
    t, b, hh, ww, four_u = gx.shape
    units = four_u // 4
    if units % 16:
        raise ValueError(f"the convlstm kernel takes U a multiple of 16, got "
                         f"U={units}")
    peeps = [fused[k] for k in _PEEPHOLES]
    device = build.same_device("convlstm_fwd", fused["Wh"], *peeps, gx, c0,
                               h0)
    elem = _DTYPES[gx.dtype]
    check_fits("convlstm_fwd", smem_bytes(hh, ww, units, elem), hh, ww, units)
    gx = aligned(gx.contiguous())
    wh = pack_slices(fused["Wh"], cluster_size(units), gx.dtype,
                     groups=GATES)
    peeps = [aligned(p.float().contiguous()) for p in peeps]
    c0 = aligned(c0.float().contiguous())
    h0 = aligned(h0.float().contiguous())
    ys = torch.empty((t, b, hh, ww, units), dtype=torch.float32,
                     device=device)
    c_final = torch.empty((b, hh, ww, units), dtype=torch.float32,
                          device=device)
    h_final = torch.empty_like(c_final)
    build.launch("convlstm_fwd", device, gx.data_ptr(), wh.data_ptr(),
                 *(p.data_ptr() for p in peeps), c0.data_ptr(),
                 h0.data_ptr(), ys.data_ptr(), c_final.data_ptr(),
                 h_final.data_ptr(), t, b, hh, ww, units, elem)
    with _count_lock:
        launches += 1
    mfu.add_kernel_flops("convlstm_fwd", flops(t, b, hh, ww, units, 4))
    return (c_final, h_final), ys


def convlstm_recurrence(fused: dict, gx_all: torch.Tensor,
                        c0: torch.Tensor, h0: torch.Tensor
                        ) -> tuple[tuple[torch.Tensor, torch.Tensor],
                                   torch.Tensor]:
    """Recurrence over precomputed input gates gx_all [T,B,H,W,4U] (bf16
    or f32) from the carries c0, h0 [B,H,W,U] -> ((c_T, h_T), ys
    [T,B,H,W,U]), all in f32. `fused` is `ConvLSTM.fuse(params)`; the state
    conv runs in gx's dtype."""
    _check(fused, gx_all, c0, h0)
    if gx_all.device.type == "cuda":
        return _launch(fused, gx_all, c0, h0)
    if gx_all.device.type != "cpu":
        raise ValueError(f"no ConvLSTM kernel for device {gx_all.device}")
    cdt = None if gx_all.dtype == torch.float32 else gx_all.dtype
    return ConvLSTM.scan_precomputed(fused, gx_all, (c0.float(), h0.float()),
                                     cdt)


def convlstm_scan(params, x_tbhwc: torch.Tensor,
                  carry0: tuple[torch.Tensor, torch.Tensor],
                  compute_dtype=torch.bfloat16
                  ) -> tuple[tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
    """`ConvLSTM.scan` with the recurrence in the kernel: the input-side
    conv over all T*B frames stays one library conv, then
    `convlstm_recurrence`. Returns ((c_T, h_T), ys) like the plain scan."""
    fused = ConvLSTM.fuse(params)
    gx_all = ConvLSTM.input_gates(fused, x_tbhwc, compute_dtype)
    return convlstm_recurrence(fused, gx_all, *carry0)
