"""Kernel Q1: a layer of the int8 C3D tower (3x3x3 SAME int8 conv, int32
accumulation, fused dequant + bias + relu + requant), and Q1-pool, the int8
max pool between layers: the hand-written CUDA kernels' wrappers, their
plain versions, and the tile plan the kernel is launched with.

There is no Pallas kernel for this. The JAX package computes a layer of
`models/quant.apply_int8` with `lax.conv_general_dilated` on int8
(`_conv3d_int8`, `models/quant.py:91-97`) and lets XLA fuse the epilogue;
PyTorch has no int8 conv3d on CUDA, so the port writes one
(`csrc/conv3d_int8.cu`).

Layouts: activations NDHWC int8 `[N, D, H, W, C]`, contiguous. Weights are
packed once, at quantize time (`pack_weights`), as `[Cout, K]` int8 rows in
(tap, ci) order, tap = (kd * 3 + kh) * 3 + kw: k = tap * Cin + ci when Cin
is a multiple of 64; otherwise each tap's channels are zero-padded to a
multiple of 4 and K to a multiple of 64 (conv1a: Cin = 3, one 32-bit word
per tap, K = 108 padded to 128). No wrapper repacks them per call. The
kernel takes Cin a multiple of 64 or Cin <= 4, and Cout a multiple of 64;
the plain version any.

The kernel's M tile is a box of 128 output positions bd x bh x bw in one
clip; `tile_plan` picks it per layer shape (least waste past the volume,
then the smallest halo, then the longest rows) together with the Cout
tile and the ring depth, and the C entry point refuses a plan it was not
built for. What bounds each layer, and what the design does about it:

* conv2a..conv5b (Cin a multiple of 64) are operation-bound. Route
  "wgmma": for each (tap, 128- or 64-byte channel chunk) one TMA load
  brings the box of x shifted by the tap (zeros outside the volume: the
  SAME padding, with no gather arithmetic) and one the weights' [BN, BK]
  slice, through an mbarrier ring to two warpgroups of
  `wgmma.mma_async` s8 x s8 -> s32 (BN = 256 where Cout allows: each A
  row is fetched once per 256 channels). The epilogue stages the box in
  shared memory and writes 16-byte rows.
* conv1a (Cin = 3, K = 81 packed to 128) would be byte-bound (2.05 GB of
  int8 out at 160 clips against 0.1 GB in); the epilogue's instructions
  per output bound it in practice. Route "halo": a persistent CTA keeps
  its 64 channels' weights in registers, stages each box's halo once in
  shared memory (a 32-bit word per position), reads its `mma.sync` A
  fragments straight from it (one fragment register is one tap's word)
  and writes the outputs as 16-byte rows.
* Both requantize through an exact estimate of y / xscale_next (the
  reciprocal, then a true division only near a rounding tie).

Bound on an H100 SXM (1,979 TOP/s dense int8, 3.35 TB/s), 2 operations per
multiply-add: a layer is max(2 * M * Cout * 27 * Cin / 1979e12, bytes /
3.35e12), with M = N * D * H * W; the tower is 77.0 GOP per 16x112x112 clip
(12.3 TOP at the served 160 clips: 6.2 ms), operation-bound but for
conv1a.

On a CUDA tensor each wrapper launches its kernel or raises (no fallback).
On a CPU tensor it runs the plain version, which the tests and
`chip_smoke.py` hold the kernels against: the conv in float64 (exact:
|acc| <= 127 * 127 * 13824 < 2^53) cast to int32, then the same epilogue
as separate torch ops in the same order.
"""

from __future__ import annotations

import functools
import threading
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...utils import mfu
from ..layers import _same_pads, max_pool3d
from . import build

# Launches of the conv kernel (Q1) and of the pool kernel (Q1-pool) in this
# process; chip_smoke.py resets them to 0 before driving a path and reads
# them after.
launches = 0
pool_launches = 0
_count_lock = threading.Lock()

QMAX = 127.0
TAPS = 27
K_ALIGN = 64  # the kernel's K chunk: the packed row length is a multiple


def tap_stride(cin: int) -> int:
    """Bytes of a packed row per tap: Cin when it is a multiple of 64, else
    Cin rounded up to a multiple of 4."""
    return cin if cin % K_ALIGN == 0 else -(-cin // 4) * 4


def packed_k(cin: int) -> int:
    """The packed weights' row length for `cin` input channels: 27 * Cin
    for Cin a multiple of 64, else 27 taps of `tap_stride(cin)` bytes
    rounded up to a multiple of 64 (the kernel's K chunk)."""
    k = TAPS * tap_stride(cin)
    return -(-k // K_ALIGN) * K_ALIGN


def pack_weights(wq: np.ndarray) -> np.ndarray:
    """int8 weights [Cout, Cin, kd, kh, kw] (the port's conv layout) ->
    the kernel's [Cout, K] rows, (tap, ci) order, zero-padded."""
    cout, cin = wq.shape[:2]
    taps = np.zeros((cout, TAPS, tap_stride(cin)), np.int8)
    taps[:, :, :cin] = np.transpose(wq, (0, 2, 3, 4, 1)).reshape(
        cout, TAPS, cin)
    out = np.zeros((cout, packed_k(cin)), np.int8)
    out[:, :taps[0].size] = taps.reshape(cout, -1)
    return out


def unpack_weights(packed: np.ndarray, cin: int) -> np.ndarray:
    """Inverse of `pack_weights`: [Cout, K] -> [Cout, Cin, 3, 3, 3]."""
    cout, stride = packed.shape[0], tap_stride(cin)
    taps = np.asarray(packed)[:, :TAPS * stride].reshape(cout, TAPS, stride)
    return np.ascontiguousarray(np.transpose(
        taps[:, :, :cin].reshape(cout, 3, 3, 3, cin), (0, 4, 1, 2, 3)))


# ------------------------------------------------------------- the tile plan

BOX_ROWS = 128  # the M tile: output positions per box
HALO_MAX = 512  # the conv1a route's halo words per box (csrc kHaloMax)
# every box of BOX_ROWS positions with power-of-two sides
BOXES = tuple((bd, bh, 128 // (bd * bh)) for bd in (1, 2, 4, 8, 16, 32, 64, 128)
              for bh in (1, 2, 4, 8, 16, 32, 64, 128) if bd * bh <= 128)


def box_waste(dhw, box) -> float:
    """Share of the positions a box grid computes that lie past the volume."""
    covered = np.prod([-(-s // b) * b for s, b in zip(dhw, box)])
    return 1.0 - float(np.prod(dhw)) / float(covered)


def halo_words(box) -> int:
    """Input positions a box of outputs reads: (bd + 2)(bh + 2)(bw + 2)."""
    return int(np.prod([b + 2 for b in box]))


def box_plan(dhw, max_halo: Optional[int] = None) -> tuple:
    """The box (bd, bh, bw) of BOX_ROWS output positions for a volume
    D x H x W: least waste, then the smallest halo (the input a box
    re-reads), then the longest contiguous rows (bw, then bh)."""
    boxes = [b for b in BOXES if max_halo is None or halo_words(b) <= max_halo]
    return min(boxes, key=lambda b: (round(box_waste(dhw, b), 12),
                                     halo_words(b), -b[2], -b[1]))


def ring_stages(bn: int, bk: int) -> int:
    """The TMA ring's depth for a Cout tile `bn` and K step `bk` (as
    csrc's `ring_stages`): at BN = 256 one CTA per SM within 200 KB of
    shared memory, below two CTAs per SM within 100 KB each, at most 6."""
    return min(6, (200 if bn == 256 else 100) * 1024 // ((BOX_ROWS + bn) * bk))


def tile_plan(x_shape, cout: int) -> dict:
    """How the kernel tiles one layer on an NDHWC input `x_shape`: the
    route ("wgmma" for Cin a multiple of 64, "halo" for Cin <= 4), the box
    of output positions, the Cout tile `bn`, the K step `bk` (bytes) and
    the ring's `stages` (the halo route's 2 halo buffers). Memoized: the
    tower asks for the same eight plans on every call."""
    return dict(_tile_plan(tuple(int(s) for s in x_shape[1:]), int(cout)))


@functools.lru_cache(maxsize=256)
def _tile_plan(dhwc: tuple, cout: int) -> dict:
    d, h, w, cin = dhwc
    if cin <= 4:
        return {"route": "halo", "box": box_plan((d, h, w), HALO_MAX),
                "bn": 64, "bk": packed_k(cin), "stages": 2}
    if cin % K_ALIGN:
        raise ValueError(f"the int8 conv kernel takes Cin <= 4 or a multiple "
                         f"of {K_ALIGN}, got {cin}")
    bn = next(b for b in (256, 128, 64) if cout % b == 0)
    bk = 128 if cin % 128 == 0 else 64
    return {"route": "wgmma", "box": box_plan((d, h, w)), "bn": bn,
            "bk": bk, "stages": ring_stages(bn, bk)}


def launch_shape(x_shape, cout: int, out_f32: bool) -> dict:
    """`tile_plan` with the CTAs of that launch that fit on an SM at once,
    as the built kernel reports them (on the card)."""
    plan = tile_plan(x_shape, cout)
    return {**plan, "ctas_per_sm": build.load().conv3d_int8_ctas_per_sm(
        x_shape[-1], plan["bn"], int(out_f32), halo_words(plan["box"]))}


def box_origins(dhw, box):
    """The boxes' first positions (d0, h0, w0) of one clip, in the order
    the kernel numbers them (w fastest)."""
    counts = [-(-s // b) for s, b in zip(dhw, box)]
    return [(i * box[0], j * box[1], k * box[2]) for i in range(counts[0])
            for j in range(counts[1]) for k in range(counts[2])]


def conv_ops(x_shape, cout: int) -> int:
    """Operations of one layer (2 per multiply-add) on an NDHWC input."""
    n, d, h, w, cin = x_shape
    return 2 * n * d * h * w * cout * TAPS * cin


def _check(x_q: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
           b: torch.Tensor) -> None:
    if x_q.dim() != 5 or x_q.dtype != torch.int8:
        raise ValueError(f"the int8 conv takes x [N,D,H,W,Cin] int8, got "
                         f"{tuple(x_q.shape)} {x_q.dtype}")
    cin = x_q.shape[-1]
    cout = wq.shape[0]
    if (wq.dtype != torch.int8 or wq.dim() != 2
            or wq.shape[1] != packed_k(cin)):
        raise ValueError(f"packed weights must be [Cout, {packed_k(cin)}] "
                         f"int8 for Cin={cin}, got {tuple(wq.shape)} "
                         f"{wq.dtype}")
    if tuple(wscale.shape) != (cout,) or tuple(b.shape) != (cout,):
        raise ValueError(f"wscale and b must be [{cout}], got "
                         f"{tuple(wscale.shape)} and {tuple(b.shape)}")


def _epilogue(acc: torch.Tensor, wscale: torch.Tensor, b: torch.Tensor,
              xscale: float, xscale_next: Optional[float]) -> torch.Tensor:
    """The kernel's epilogue as torch ops, in its order: int32 -> f32
    (round to nearest), times alpha = xscale * wscale, plus b, relu; then
    round-half-even(y / xscale_next) clipped to +-127 as int8. The scales
    are f32 tensors on the data's device, so the division is a true
    division (PyTorch divides by a CPU scalar through its reciprocal)."""
    dev = acc.device
    alpha = torch.tensor(xscale, dtype=torch.float32, device=dev) * wscale
    y = torch.relu(acc.float() * alpha + b)
    if xscale_next is None:
        return y
    nxt = torch.tensor(xscale_next, dtype=torch.float32, device=dev)
    return quantize(y, nxt)


def quantize(x: torch.Tensor, scale) -> torch.Tensor:
    """clip(round_half_even(x / scale), +-127) as int8 (`_quantize_tensor`
    of the JAX package); `scale` a float or an f32 tensor."""
    if not isinstance(scale, torch.Tensor):
        scale = torch.tensor(scale, dtype=torch.float32, device=x.device)
    return torch.round(x / scale).clamp_(-QMAX, QMAX).to(torch.int8)


def conv3d_int32_plain(x_q: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The int8 conv's int32 sums [N,D,H,W,Cout] (the JAX package's
    `_conv3d_int8`), computed in float64, which is exact here."""
    w = torch.from_numpy(unpack_weights(wq.cpu().numpy(), x_q.shape[-1]))
    w = w.to(device=x_q.device, dtype=torch.float64)
    acc = F.conv3d(x_q.permute(0, 4, 1, 2, 3).double(), w, padding=1)
    return acc.permute(0, 2, 3, 4, 1).to(torch.int32)


def conv3d_int8_plain(x_q: torch.Tensor, wq: torch.Tensor,
                      wscale: torch.Tensor, b: torch.Tensor, xscale: float,
                      xscale_next: Optional[float] = None) -> torch.Tensor:
    """The plain version of Q1: `conv3d_int32_plain`, then `_epilogue`.
    Same arguments and result as `conv3d_int8`."""
    _check(x_q, wq, wscale, b)
    return _epilogue(conv3d_int32_plain(x_q, wq), wscale, b, xscale,
                     xscale_next).contiguous()


def _launch(x_q, wq, wscale, b, xscale, xscale_next) -> torch.Tensor:
    global launches
    device = build.same_device("conv3d_int8", x_q, wq, wscale, b)
    n, d, h, w, cin = x_q.shape
    cout = wq.shape[0]
    if cout % 64 or not (cin <= 4 or cin % K_ALIGN == 0):
        raise ValueError(f"the int8 conv kernel takes Cout a multiple of 64 "
                         f"and Cin <= 4 or a multiple of 64, got Cin={cin}, "
                         f"Cout={cout}")
    x_q = x_q.contiguous()
    wq = wq.contiguous()
    wscale = wscale.float().contiguous()
    b = b.float().contiguous()
    if x_q.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("the int8 conv kernel reads 16-byte aligned x and "
                         "weights")
    plan = tile_plan(x_q.shape, cout)
    out_f32 = xscale_next is None
    out = torch.empty((n, d, h, w, cout),
                      dtype=torch.float32 if out_f32 else torch.int8,
                      device=device)
    build.launch("conv3d_int8", device, x_q.data_ptr(), wq.data_ptr(),
                 wscale.data_ptr(), b.data_ptr(), float(xscale),
                 1.0 if out_f32 else float(xscale_next), int(out_f32),
                 out.data_ptr(), n, d, h, w, cin, cout, wq.shape[1],
                 *plan["box"], plan["bn"], plan["stages"])
    with _count_lock:
        launches += 1
    mfu.add_kernel_flops("conv3d_int8", conv_ops(x_q.shape, cout))
    return out


def conv3d_int8(x_q: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
                b: torch.Tensor, xscale: float,
                xscale_next: Optional[float] = None) -> torch.Tensor:
    """One layer of `apply_int8`: x_q [N,D,H,W,Cin] int8 (quantized at
    `xscale`), packed weights wq [Cout, Kpad] int8 with their per-channel
    scales `wscale` [Cout] and bias `b` [Cout] (f32) -> relu(conv * xscale
    * wscale + b) requantized at `xscale_next` as int8 [N,D,H,W,Cout], or
    in f32 when `xscale_next` is None (conv5b)."""
    _check(x_q, wq, wscale, b)
    if x_q.device.type == "cuda":
        return _launch(x_q, wq, wscale, b, xscale, xscale_next)
    if x_q.device.type != "cpu":
        raise ValueError(f"no int8 conv kernel for device {x_q.device}")
    return conv3d_int8_plain(x_q, wq, wscale, b, xscale, xscale_next)


# ------------------------------------------------------------- Q1-pool

def maxpool3d_int8_plain(x_q: torch.Tensor, window, stride) -> torch.Tensor:
    """The plain version of Q1-pool: widen to f32 (exact for int8), pool
    with the tower's SAME semantics (`ops.layers.max_pool3d`: -inf
    padding), narrow back; NDHWC in and out."""
    y = max_pool3d(x_q.permute(0, 4, 1, 2, 3).float(), window, stride)
    return y.to(torch.int8).permute(0, 2, 3, 4, 1).contiguous()


def maxpool3d_int8(x_q: torch.Tensor, window, stride) -> torch.Tensor:
    """SAME max pool of NDHWC int8 [N,D,H,W,C] (C a multiple of 16 on the
    card) -> int8 [N, ceil(D/sd), ceil(H/sh), ceil(W/sw), C]; a padded
    element never wins (the JAX package pads with the lowest value)."""
    global pool_launches
    if x_q.dim() != 5 or x_q.dtype != torch.int8:
        raise ValueError(f"the int8 pool takes [N,D,H,W,C] int8, got "
                         f"{tuple(x_q.shape)} {x_q.dtype}")
    if x_q.device.type == "cpu":
        return maxpool3d_int8_plain(x_q, window, stride)
    if x_q.device.type != "cuda":
        raise ValueError(f"no int8 pool kernel for device {x_q.device}")
    n, d, h, w, c = x_q.shape
    if c % 16:
        raise ValueError(f"the int8 pool kernel takes C a multiple of 16, "
                         f"got {c}")
    x_q = x_q.contiguous()
    outs = [-(-s // st) for s, st in zip((d, h, w), stride)]
    pads = [_same_pads(s, k, st)[0] for s, k, st in
            zip((d, h, w), window, stride)]
    out = torch.empty((n, *outs, c), dtype=torch.int8, device=x_q.device)
    build.launch("maxpool3d_int8", x_q.device, x_q.data_ptr(),
                 out.data_ptr(), n, d, h, w, c, *outs, *window, *stride,
                 *pads)
    with _count_lock:
        pool_launches += 1
    return out
