"""ConvGRU custom backward, v1 (monolithic): the hand-written CUDA kernel's
wrapper, its plain version, and the autograd Function around them.

Replaces the TPU kernel `_convgru_bwd_kernel` of the JAX package's
`ops/pallas/convgru_vjp.py` (`_convgru_bwd_pallas`, custom VJP
`convgru_scan_fused`, entry point `convgru_scan_trainable`). The kernel
(`csrc/convgru_bwd_mono.cu`) walks T in reverse in one launch, one block
per batch element: it recomputes u, r, c from h_{t-1}, applies both
transposed convs, and accumulates dU_zr and dU_c in a per-block f32 partial
in device memory, summed over B after the launch.

Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s) at T=42, U=128 in bf16:
operations, 3x the forward's FLOPs (43.7 GFLOP at B=8, 44.2 us; 87.4 GFLOP
at B=16, 88.4 us), against ~58 MB moved at B=8.

Numerics rule (as in the forward kernel): all elementwise math is f32; in
bf16 mode (wx in bf16) every conv operand, the cotangents and the weights
included, is rounded to bf16 and the products are summed in f32; in f32
mode everything is f32. The plain versions here round the same way, so the
card's check compares like with like. The JAX kernel casts its weights to
f32 (`convgru_vjp.py:173`); on the TPU its f32 dots round their operands to
bf16 at default precision, which is the rule written out.

Also holds the plain conv helpers shared with v2 (`convgru_vjp2.py`):
`conv3x3_transpose` and `kernel_grad`, copies of the JAX package's
`_conv3x3_transpose`, `_conv3x3_kernel_grad`, `_patches` and `_kernel_grad`.

On a CUDA tensor the wrapper launches the kernel or raises (no fallback);
on a CPU tensor it runs the plain version, `convgru_bwd_plain`.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch
import torch.nn.functional as F

from ..cells import ConvGRU
from ..layers import conv2d
from . import build
from .convgru import convgru_recurrence

# Launches of the CUDA kernel in this process; chip_smoke.py resets it to
# 0 before driving a path and reads it after.
launches = 0
_count_lock = threading.Lock()

_DTYPES = {torch.bfloat16: 2, torch.float32: 4}


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
    device = build.same_device("convgru_bwd_mono", uzr, uc, wx, ys, h0, g)
    elem = _DTYPES[wx.dtype]
    build.check_shared_memory("convgru_bwd_mono", hh, ww, units, elem)
    wx = wx.contiguous()
    hprev = hprev_of(h0, ys).contiguous()
    g = g.float().contiguous()
    weights = [w.to(wx.dtype).contiguous() for w in (
        uzr, uc, transposed_weight(uzr), transposed_weight(uc))]
    f32 = dict(dtype=torch.float32, device=device)
    dwx = torch.empty((t, b, hh, ww, three_u), **f32)
    dh0 = torch.empty((b, hh, ww, units), **f32)
    duzr_part = torch.empty((b, 3, 3, units, 2 * units), **f32)
    duc_part = torch.empty((b, 3, 3, units, units), **f32)
    workspace = torch.empty(build.load().convgru_bwd_mono_workspace_bytes(
        b, hh, ww, units, elem), dtype=torch.uint8, device=device)
    build.launch("convgru_bwd_mono", device, wx.data_ptr(), hprev.data_ptr(),
                 g.data_ptr(), *(w.data_ptr() for w in weights),
                 dwx.data_ptr(), dh0.data_ptr(), duzr_part.data_ptr(),
                 duc_part.data_ptr(), workspace.data_ptr(), t, b, hh, ww,
                 units, elem)
    with _count_lock:
        launches += 1
    # one deterministic reduction of the per-block partials over B
    return dwx, dh0, duzr_part.sum(dim=0), duc_part.sum(dim=0)


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


class ConvGRUFusedV1(torch.autograd.Function):
    """The differentiable recurrence over precomputed gates, the port of
    `convgru_scan_fused`: forward is kernel B1 (`convgru_recurrence`),
    backward the monolithic kernel. Saves only ys (the gates are
    recomputed), like the JAX custom VJP."""

    @staticmethod
    def forward(ctx, uzr, uc, wx, h0):
        _, ys = convgru_recurrence({"Uh_zr": uzr, "U_c": uc}, wx, h0)
        ctx.save_for_backward(uzr, uc, wx, h0, ys)
        return ys

    @staticmethod
    def backward(ctx, g):
        uzr, uc, wx, h0, ys = ctx.saved_tensors
        dwx, dh0, duzr, duc = convgru_bwd(uzr, uc, wx, ys, h0, g)
        return (duzr.to(uzr.dtype), duc.to(uc.dtype), dwx.to(wx.dtype),
                dh0.to(h0.dtype))


def convgru_scan_trainable(params, x_tbhwc: torch.Tensor, h0: torch.Tensor,
                           compute_dtype=torch.bfloat16
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for `ConvGRU.scan` with the kernels forward AND backward
    (v1). The input-side conv stays one library conv, differentiated by
    autograd. Returns (ys[-1], ys)."""
    fused = ConvGRU.fuse(params)
    wx_all = ConvGRU.input_gates(fused, x_tbhwc, compute_dtype)
    ys = ConvGRUFusedV1.apply(fused["Uh_zr"], fused["U_c"], wx_all,
                              h0.float())
    return ys[-1], ys
