"""MFU (model FLOPs utilization) accounting: the port's counterpart of the
JAX package's `utils/mfu.py`.

FLOPs per call are the contractions (convolutions and matmuls) one call
of a function runs, as `torch.utils.flop_counter.FlopCounterMode` counts
them where PyTorch dispatches them, forward and backward. The hand-written
kernels launch through ctypes, where the dispatcher does not see them, so
each kernel wrapper adds its launch's contractions from its shapes
(`add_kernel_flops`) to every counter open at the launch: the kernel route
and the plain route of one program count the same contractions. As in the
JAX version, elementwise work is not counted: MFU is anchored on the
contractions.

The JAX version reads XLA's cost model and corrects it by parsing the
optimized HLO, because XLA counts a loop body once (its `utils/mfu.py`
from the scan-body correction on). Nothing here corresponds to that part:
a Python loop dispatches, and so counts, every step.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

# Peak dense bf16 FLOP/s per card, keyed by `torch.cuda.get_device_name()`.
# Source: NVIDIA's H100 data sheet (SXM part, without sparsity), at the
# full 700 W power limit.
PEAK_FLOPS_PER_CHIP = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def peak_flops(device=None) -> Optional[float]:
    """Peak bf16 FLOP/s of `device` (None = the current CUDA device), or
    None where it is unknown: on the CPU, or a card not in the table."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return None
    return PEAK_FLOPS_PER_CHIP.get(torch.cuda.get_device_name(device))


def add_kernel_flops(name: str, flops: int) -> None:
    """Add one launch of the hand-written kernel `name` to every
    FlopCounterMode open on this thread (the autograd engine's threads
    inherit the caller's), under the key `name`. Kernel wrappers call it
    where they launch."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    from torch.utils.flop_counter import FlopCounterMode

    for mode in _get_current_dispatch_mode_stack():
        counter = getattr(mode, "counter", mode)
        if isinstance(counter, FlopCounterMode):
            tracker = getattr(counter, "mod_tracker", None)
            for parent in set(getattr(tracker, "parents", None)
                              or {"Global"}):
                counter.flop_counts[parent][name] += flops


def flop_counts(fn: Callable, *args, **kwargs) -> dict[str, int]:
    """The contractions of one call `fn(*args, **kwargs)`, by source: each
    aten op FlopCounterMode counts ("aten.convolution", "aten.mm", ...)
    and each hand-written kernel by name ("convgru_fwd", ...)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return {str(op): int(n)
            for op, n in counter.get_flop_counts()["Global"].items()}


def compiled_flops(fn: Callable, *args, **kwargs) -> float:
    """FLOPs of one call `fn(*args, **kwargs)`: the sum of
    `flop_counts`."""
    return float(sum(flop_counts(fn, *args, **kwargs).values()))


def mfu(flops_per_call: Optional[float], calls_per_sec: float,
        device=None) -> Optional[float]:
    """Utilization in [0, 1]: achieved FLOP/s over the device's peak; None
    where the peak is unknown."""
    peak = peak_flops(device)
    if not peak or not flops_per_call:
        return None
    return flops_per_call * calls_per_sec / peak
