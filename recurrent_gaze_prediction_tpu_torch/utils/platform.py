"""Device selection for the port's entry points.

Every entry point takes a `device`; None means the card. Nothing moves to
the CPU unless the caller asks for it (the CPU tests pass "cpu").
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """None -> "cuda". Raises RuntimeError when CUDA is asked for (or
    implied) on a host without it, instead of carrying on on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run on the CPU")
    return dev
