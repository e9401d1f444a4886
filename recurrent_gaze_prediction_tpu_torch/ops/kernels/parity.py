"""Parity check on the card: the CUDA ConvGRU kernel against its plain
version (`ConvGRU.scan`), the counterpart of the JAX package's
`ops/pallas/parity.py`.

`convgru_parity()` runs the SAME params and inputs through the kernel's
wrapper and the plain scan on one device and reports agreement. On a CPU
device both paths are the plain scan, so only a CUDA run checks the
kernel (chip_smoke.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ...utils import resolve_device
from ..cells import ConvGRU
from .convgru import convgru_scan

# The gate the JAX package puts on its TPU kernel (bf16 production mode):
# loose enough for run-to-run and rounding-order noise, tight enough that a
# wrong gate or a wrong conv shift (corr << 0.99) cannot pass.
BF16_MAX_REL_DELTA = 0.05
MIN_CORR = 0.999


def convgru_parity(t: int = 42, b: int = 8, hw: tuple[int, int] = (7, 7),
                   c: int = 512, units: int = 128,
                   compute_dtype=torch.bfloat16, seed: int = 0,
                   device=None) -> dict:
    """Run the kernel and `ConvGRU.scan` on identical inputs at the
    flagship gaze_grcn shapes; return agreement stats.

    Both paths use `compute_dtype`. The kernel keeps its conv results in
    f32 where the plain scan rounds them to the compute dtype, so bf16
    agreement is bounded by bf16 resolution. `max_rel_delta` is measured
    against the hidden-state scale, `corr` over all T*B*H*W*U outputs, and
    `final_h_max_delta` compares the kernel's final state with its ys[-1].
    """
    dev = resolve_device(device)
    h, w = hw
    rng = np.random.RandomState(seed)
    shapes = ConvGRU.init(c, units)
    params = {k: torch.from_numpy(
        rng.randn(*v.shape).astype(np.float32) * 0.1).to(dev)
        for k, v in shapes.items()}
    xs = torch.from_numpy(rng.randn(t, b, h, w, c).astype(np.float32)).to(dev)
    h0 = ConvGRU.zero_state(b, (h, w), units, device=dev)

    with torch.inference_mode():
        _, ys_plain = ConvGRU.scan(params, xs, h0, compute_dtype=compute_dtype)
        h_kernel, ys_kernel = convgru_scan(params, xs, h0,
                                           compute_dtype=compute_dtype)
    a = ys_plain.float().cpu().numpy().ravel()
    p = ys_kernel.float().cpu().numpy().ravel()
    scale = float(np.abs(a).max()) or 1.0
    max_delta = float(np.abs(a - p).max())
    corr = float(np.corrcoef(a, p)[0, 1]) if a.std() > 0 else float("nan")
    return {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "compute_dtype": str(compute_dtype).replace("torch.", ""),
        "shape": {"t": t, "b": b, "h": h, "w": w, "c": c, "units": units},
        "max_delta": max_delta,
        "max_rel_delta": max_delta / scale,
        "corr": corr,
        "final_h_max_delta": float(
            (h_kernel - ys_kernel[-1]).abs().max().item()),
    }


def parity_ok(stats: dict, max_rel_delta: float = BF16_MAX_REL_DELTA) -> bool:
    return bool(np.isfinite(stats["corr"]) and stats["corr"] >= MIN_CORR
                and stats["max_rel_delta"] <= max_rel_delta
                and stats["final_h_max_delta"] == 0.0)
