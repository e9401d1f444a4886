"""Which recurrence runs, chosen in one place from a cell's shapes alone:
`convgru_route` / `convlstm_route` answer "kernel" or "scan" before any
launch, `run_convgru` / `run_convlstm` run the recurrence by the answer.
A ConvGRU's kernel route is B1 (`convgru`) to predict and the trainable
Function (`convgru_vjp`: B1; G, B2 and W) to train, for the 3x3 cells B1
takes; else B5 (`convgru_small`) for the cascade's 5x5 U=3 top cell; else
B6 (`convgru_grid`, forward and backward's recursion, then W) for a 3x3
cell too wide for B1, the cascade's U=256 bottom cell. The three take no
shape in common: B5 no 3x3 cell, B6 none that B1 takes. A ConvLSTM's is B3
(`convlstm`), to predict only (no backward kernel, as in the JAX package).
"scan" is the cell's own scan, which runs any shape. On a CPU tensor the
kernel routes run their plain versions.
"""

from __future__ import annotations

import torch

from ..cells import ConvGRU, ConvLSTM
from . import convgru, convgru_grid, convgru_small, convgru_vjp, convlstm


def _kernel_scan(cell, hw: tuple[int, int], compute_dtype: torch.dtype,
                 train: bool):
    """The kernel scan that takes the cell (params `cell`) on an `hw` grid
    in `compute_dtype`, or None: B1 (and to train G, B2 and W), B5, B6."""
    kernel = ConvGRU.kernel_size(cell)
    units = cell["U"].shape[-1]
    if convgru.kernel_takes(*hw, units, compute_dtype, kernel):
        if not train:
            return convgru.convgru_scan
        if convgru_vjp.kernel_takes(*hw, units, compute_dtype, kernel):
            return convgru_vjp.convgru_scan_trainable
        return None
    for module, scan in ((convgru_small, convgru_small.convgru_scan_small),
                         (convgru_grid, convgru_grid.convgru_scan_grid)):
        if module.kernel_takes(*hw, units, compute_dtype, kernel):
            return scan
    return None


def convgru_route(cell, hw: tuple[int, int], compute_dtype: torch.dtype,
                  train: bool) -> str:
    """"kernel" when B1 (and to train G, B2 and W), B5 or B6 takes the cell
    (params `cell`) on an `hw` grid in `compute_dtype`, else "scan"."""
    return "scan" if _kernel_scan(cell, hw, compute_dtype,
                                  train) is None else "kernel"


def run_convgru(cell, xs: torch.Tensor, h0: torch.Tensor, *,
                compute_dtype, train: bool, route: str, remat: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """`ConvGRU.scan(cell, xs, h0)` by `route` (`convgru_route`'s answer)
    -> (final_h, ys). `remat` checkpoints each step of the plain scan; the
    kernels keep no per-step graph either way."""
    if route == "scan":
        return ConvGRU.scan(cell, xs, h0, compute_dtype=compute_dtype,
                            remat=remat)
    scan = _kernel_scan(cell, tuple(xs.shape[2:4]), compute_dtype, train)
    if scan is None:
        raise ValueError(f"route 'kernel' for a cell no kernel takes: U="
                         f"{cell['U'].shape[-1]}, kernel "
                         f"{ConvGRU.kernel_size(cell)}, grid "
                         f"{tuple(xs.shape[2:4])}, {compute_dtype}, train "
                         f"{train}")
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
