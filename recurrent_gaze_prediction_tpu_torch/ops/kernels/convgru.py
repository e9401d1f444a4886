"""ConvGRU recurrence: the hand-written CUDA kernel's wrapper.

Replaces the TPU kernel `_convgru_seq_kernel` of the JAX package's
`ops/pallas/convgru.py` (`convgru_scan_pallas`, wrapper `convgru_scan`).
The kernel (`csrc/convgru_fwd.cu`) runs the whole recurrence over T in one
launch, one block per batch element, with h in shared memory and the
state convs on the tensor cores in bf16.

Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s) at T=42, U=128 in bf16:
operations, T*B*49*9*U*3U*2 = 14.6 GFLOP at B=8 (15 us) and 29.1 GFLOP at
B=16 (29 us), against ~43 MB moved at B=16 (13 us). The design keeps h and
the gates out of device memory; its one-block-per-element grid leaves most
SMs idle at B <= 32, which is what a cluster split would address.

On a CUDA tensor the wrapper launches the kernel or raises (no fallback).
On a CPU tensor it runs the plain version, `ConvGRU.scan_precomputed`,
which the tests and `chip_smoke.py` hold the kernel against.
"""

from __future__ import annotations

import threading

import torch

from ..cells import ConvGRU
from . import build

# Launches of the CUDA kernel in this process; chip_smoke.py resets it to
# 0 before driving the serving path and reads it after.
launches = 0
_count_lock = threading.Lock()

_DTYPES = {torch.bfloat16: 2, torch.float32: 4}


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
    build.check_shared_memory("convgru_fwd", hh, ww, units, elem)
    wx = wx.contiguous()
    u_zr = u_zr.to(wx.dtype).contiguous()
    u_c = u_c.to(wx.dtype).contiguous()
    h0 = h0.float().contiguous()
    ys = torch.empty((t, b, hh, ww, units), dtype=torch.float32,
                     device=device)
    h_final = torch.empty((b, hh, ww, units), dtype=torch.float32,
                          device=device)
    build.launch("convgru_fwd", device, wx.data_ptr(), u_zr.data_ptr(),
                 u_c.data_ptr(), h0.data_ptr(), ys.data_ptr(),
                 h_final.data_ptr(), t, b, hh, ww, units, elem)
    with _count_lock:
        launches += 1
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
