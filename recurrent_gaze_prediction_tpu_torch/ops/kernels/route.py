"""Which recurrence runs, chosen in one place from a cell's shapes alone:
`convgru_route` / `convlstm_route` answer "kernel" or "scan" before any
launch, `run_convgru` / `run_convlstm` run the recurrence by the answer.
A ConvGRU's kernel route is B5 (`convgru_small`) for the cascade's 5x5 U=3
top cell, else B1 (`convgru`) to predict and the trainable Function
(`convgru_vjp`: B1; G, B2 and W) to train; B5 takes no 3x3 cell, B1 only
3x3. A ConvLSTM's is B3 (`convlstm`), to predict only (no backward kernel,
as in the JAX package). "scan" is the cell's own scan, which runs any
shape. On a CPU tensor the kernel routes run their plain versions.
"""

from __future__ import annotations

import torch

from ..cells import ConvGRU, ConvLSTM
from . import convgru, convgru_small, convgru_vjp, convlstm


def convgru_route(cell, hw: tuple[int, int], compute_dtype: torch.dtype,
                  train: bool) -> str:
    """"kernel" when B1 (and to train G, B2 and W) or B5 takes the cell
    (params `cell`) on an `hw` grid in `compute_dtype`, else "scan"."""
    kernel = ConvGRU.kernel_size(cell)
    units = cell["U"].shape[-1]
    b1 = convgru.kernel_takes(*hw, units, compute_dtype, kernel) and (
        not train
        or convgru_vjp.kernel_takes(*hw, units, compute_dtype, kernel))
    if b1 or convgru_small.kernel_takes(*hw, units, compute_dtype, kernel):
        return "kernel"
    return "scan"


def run_convgru(cell, xs: torch.Tensor, h0: torch.Tensor, *,
                compute_dtype, train: bool, route: str, remat: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """`ConvGRU.scan(cell, xs, h0)` by `route` (`convgru_route`'s answer)
    -> (final_h, ys). `remat` checkpoints each step of the plain scan; the
    kernels keep only ys either way."""
    if route == "scan":
        return ConvGRU.scan(cell, xs, h0, compute_dtype=compute_dtype,
                            remat=remat)
    if ConvGRU.kernel_size(cell) != (3, 3):  # the kernel route is B5's
        return convgru_small.convgru_scan_small(cell, xs, h0,
                                                compute_dtype=compute_dtype)
    scan = (convgru_vjp.convgru_scan_trainable if train
            else convgru.convgru_scan)
    return scan(cell, xs, h0, compute_dtype=compute_dtype)


def convlstm_route(units: int, hw: tuple[int, int],
                   compute_dtype: torch.dtype, train: bool) -> str:
    """"kernel" when B3 takes U units on an `hw` grid in `compute_dtype`,
    to predict only, else "scan"."""
    if not train and convlstm.kernel_takes(*hw, units, compute_dtype):
        return "kernel"
    return "scan"


def run_convlstm(cell, xs: torch.Tensor,
                 carry0: tuple[torch.Tensor, torch.Tensor], *, compute_dtype,
                 route: str):
    """`ConvLSTM.scan(cell, xs, carry0)` by `route` (`convlstm_route`'s
    answer) -> ((c_T, h_T), ys)."""
    scan = convlstm.convlstm_scan if route == "kernel" else ConvLSTM.scan
    return scan(cell, xs, carry0, compute_dtype=compute_dtype)
