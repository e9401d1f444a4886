"""ConvGRU (GRU-RCN) cell: the port's counterpart of `ConvGRU` in the JAX
package's `ops/cells.py`.

Six per-gate 3x3 kernels without biases (Ballas et al., arXiv:1511.06432),
stored per gate (W_z, U_z, W_r, U_r, W, U) for checkpoint parity and fused
into three convs: the input side z|r|candidate in one conv hoisted out of
the time loop, the state side z|r in one conv, and the candidate's state
conv after the reset gate.

`ConvGRU.scan` is the PLAIN version of the hand-written CUDA kernel
(`ops/kernels/convgru.py`): the tests hold the kernel against it, and the
kernel's wrapper runs it for tensors that lie on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import initializers as init
from .layers import conv2d


class ConvGRU:
    """Gate equations (reference `gaze_grcn.py:108-129`):

        u = sigmoid(conv(x, W_z) + conv(h, U_z))
        r = sigmoid(conv(x, W_r) + conv(h, U_r))
        c = tanh(conv(x, W) + conv(r * h, U))
        h' = u * h + (1 - u) * c
    """

    @staticmethod
    def init(dim_feature: int, num_units: int, stddev: float = 1e-4, *,
             generator: Optional[torch.Generator] = None) -> dict:
        shape_w = (3, 3, dim_feature, num_units)
        shape_u = (3, 3, num_units, num_units)
        return {
            name: init.truncated_normal(shape, stddev, generator=generator)
            for name, shape in (("W_z", shape_w), ("U_z", shape_u),
                                ("W_r", shape_w), ("U_r", shape_u),
                                ("W", shape_w), ("U", shape_u))
        }

    @staticmethod
    def fuse(params) -> dict:
        """Concatenate per-gate kernels along the output-channel axis, once
        per sequence, outside the time loop."""
        return {
            "Wx_zrc": torch.cat(
                [params["W_z"], params["W_r"], params["W"]], dim=-1),
            "Uh_zr": torch.cat([params["U_z"], params["U_r"]], dim=-1),
            "U_c": params["U"],
        }

    @staticmethod
    def step_precomputed(fused: dict, h: torch.Tensor, wx: torch.Tensor,
                         compute_dtype=None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
        """One step given the precomputed input-side conv `wx` (3U
        channels). Only the two state-dependent convs remain sequential."""
        units = fused["U_c"].shape[-1]
        uh = conv2d(h, fused["Uh_zr"], compute_dtype=compute_dtype)
        wz, wr, wc = torch.split(wx, units, dim=-1)
        uz, ur = torch.split(uh, units, dim=-1)
        u = torch.sigmoid(wz + uz)
        r = torch.sigmoid(wr + ur)
        c = torch.tanh(wc + conv2d(r * h, fused["U_c"],
                                   compute_dtype=compute_dtype))
        new_h = u * h + (1.0 - u) * c
        return new_h, new_h

    @staticmethod
    def zero_state(batch: int, spatial: tuple[int, int], num_units: int, *,
                   device=None, dtype=torch.float32) -> torch.Tensor:
        return torch.zeros((batch, spatial[0], spatial[1], num_units),
                           dtype=dtype, device=device)

    @staticmethod
    def scan_precomputed(fused: dict, wx_all: torch.Tensor,
                         h0: torch.Tensor, compute_dtype=None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
        """The recurrence over precomputed input gates wx_all
        [T, B, H, W, 3U] -> (final_h, ys [T, B, H, W, U]): the plain
        version of exactly what the CUDA kernel computes."""
        h = h0
        ys = []
        for wx in wx_all:
            h, y = ConvGRU.step_precomputed(fused, h, wx,
                                            compute_dtype=compute_dtype)
            ys.append(y)
        return h, torch.stack(ys)

    @staticmethod
    def input_gates(fused: dict, x_tbhwc: torch.Tensor,
                    compute_dtype=None) -> torch.Tensor:
        """The hoisted input-side conv for all T*B frames as ONE batched
        conv: [T, B, H, W, C] -> [T, B, H, W, 3U] in the compute dtype."""
        t, b = x_tbhwc.shape[:2]
        wx = conv2d(x_tbhwc.reshape(t * b, *x_tbhwc.shape[2:]),
                    fused["Wx_zrc"], compute_dtype=compute_dtype,
                    out_dtype=compute_dtype)
        return wx.reshape(t, b, *wx.shape[1:])

    @staticmethod
    def scan(params, x_tbhwc: torch.Tensor, h0: torch.Tensor,
             compute_dtype=None) -> tuple[torch.Tensor, torch.Tensor]:
        """Run over time-major inputs [T, B, H, W, C] -> (final_h,
        outputs [T, B, H, W, U]). The input-side conv is hoisted out of
        the loop; only the state convs stay sequential."""
        fused = ConvGRU.fuse(params)
        wx_all = ConvGRU.input_gates(fused, x_tbhwc, compute_dtype)
        return ConvGRU.scan_precomputed(fused, wx_all, h0, compute_dtype)
