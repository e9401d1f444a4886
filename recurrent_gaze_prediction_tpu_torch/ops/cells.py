"""Recurrent cells: the port's counterparts of `ConvGRU`, `ConvLSTM` and
`FlatGRU` in the JAX package's `ops/cells.py`.

ConvGRU (GRU-RCN): six per-gate kernels without biases (Ballas et al.,
arXiv:1511.06432), 3x3 by default (the cascade's top cell is 5x5), stored
per gate (W_z, U_z, W_r, U_r, W, U) for checkpoint parity and fused into
three convs: the input side z|r|candidate in one conv hoisted out of the
time loop, the state side z|r in one conv, and the candidate's state conv
after the reset gate. `scan(..., remat=True)` checkpoints each step
(`torch.utils.checkpoint`), the counterpart of the JAX package's
`jax.checkpoint`: the backward recomputes a step's gates instead of
keeping them, and no number changes.

ConvLSTM (peephole): eight 3x3 kernels without biases and three
elementwise peephole weights W_ci/W_cf/W_co [H, W, U], fused into two
convs (the input side i|f|c|o hoisted out of the time loop, the state side
i|f|c|o). Two deviations from the reference are intended and kept, as in
the JAX package: the candidate convolves h with W_hc (the reference uses
W_hi there), and the output gate peeps at the OLD cell state.

FlatGRU: TF's `GRUCell` on flat vectors (the flat gaze_rnn and the pupil
prototype gaze_pupil_gru2), with its input-side matmuls hoisted out of the
time loop. No TPU kernel covers it, so it has no CUDA kernel either.

`ConvGRU.scan` and `ConvLSTM.scan` are the PLAIN versions of the
hand-written CUDA kernels (`ops/kernels/convgru.py`,
`ops/kernels/convlstm.py`): the tests hold the kernels against them, and
the kernels' wrappers run them for tensors that lie on the CPU. Each call
of their step loops counts its T steps in `recurrence.plain_steps`
(`train.profiler.count`, on the innermost recorded span).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..train.profiler import count
from . import initializers as init
from .layers import conv2d, linear


class ConvGRU:
    """Gate equations (reference `gaze_grcn.py:108-129`):

        u = sigmoid(conv(x, W_z) + conv(h, U_z))
        r = sigmoid(conv(x, W_r) + conv(h, U_r))
        c = tanh(conv(x, W) + conv(r * h, U))
        h' = u * h + (1 - u) * c
    """

    @staticmethod
    def init(dim_feature: int, num_units: int,
             kernel: tuple[int, int] = (3, 3), stddev: float = 1e-4, *,
             generator: Optional[torch.Generator] = None) -> dict:
        kh, kw = kernel
        shape_w = (kh, kw, dim_feature, num_units)
        shape_u = (kh, kw, num_units, num_units)
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
                         h0: torch.Tensor, compute_dtype=None,
                         remat: bool = False
                         ) -> tuple[torch.Tensor, torch.Tensor]:
        """The recurrence over precomputed input gates wx_all
        [T, B, H, W, 3U] -> (final_h, ys [T, B, H, W, U]): the plain
        version of exactly what the CUDA kernel computes. `remat=True`
        checkpoints each step: autograd keeps only its inputs h and wx."""
        def step(h, wx):
            return ConvGRU.step_precomputed(fused, h, wx,
                                            compute_dtype=compute_dtype)[0]

        count("recurrence.plain_steps", len(wx_all))
        h = h0
        ys = []
        for wx in wx_all:
            h = (checkpoint(step, h, wx, use_reentrant=False) if remat
                 else step(h, wx))
            ys.append(h)
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
             compute_dtype=None, remat: bool = False
             ) -> tuple[torch.Tensor, torch.Tensor]:
        """Run over time-major inputs [T, B, H, W, C] -> (final_h,
        outputs [T, B, H, W, U]). The input-side conv is hoisted out of
        the loop; only the state convs stay sequential. `remat=True`
        rematerializes each step in the backward pass."""
        fused = ConvGRU.fuse(params)
        wx_all = ConvGRU.input_gates(fused, x_tbhwc, compute_dtype)
        return ConvGRU.scan_precomputed(fused, wx_all, h0, compute_dtype,
                                        remat)

    @staticmethod
    def kernel_size(params) -> tuple[int, int]:
        """The (kh, kw) of a cell's kernels."""
        return tuple(params["U"].shape[:2])


class ConvLSTM:
    """Gate equations (reference `gaze_lstm.py:103-133`):

        i  = sigmoid(conv(x, W_xi) + conv(h, W_hi) + W_ci * c)
        f  = sigmoid(conv(x, W_xf) + conv(h, W_hf) + W_cf * c)
        c' = f * c + i * tanh(conv(x, W_xc) + conv(h, W_hc))
        o  = sigmoid(conv(x, W_xo) + conv(h, W_ho) + W_co * c)   # OLD c
        h' = tanh(c') * o
    """

    GATES = ("i", "f", "c", "o")

    @staticmethod
    def init(dim_feature: int, num_units: int,
             spatial: tuple[int, int] = (7, 7), stddev: float = 1e-4, *,
             generator: Optional[torch.Generator] = None) -> dict:
        shape_x = (3, 3, dim_feature, num_units)
        shape_h = (3, 3, num_units, num_units)
        shape_peep = (spatial[0], spatial[1], num_units)
        shapes = {}
        for gate in ConvLSTM.GATES:
            shapes[f"W_x{gate}"] = shape_x
            shapes[f"W_h{gate}"] = shape_h
            if gate != "c":
                shapes[f"W_c{gate}"] = shape_peep
        return {name: init.truncated_normal(shape, stddev, generator=generator)
                for name, shape in shapes.items()}

    @staticmethod
    def fuse(params) -> dict:
        """Concatenate the per-gate kernels in the gate order i, f, c, o,
        once per sequence, outside the time loop."""
        return {
            "Wx": torch.cat([params[f"W_x{g}"] for g in ConvLSTM.GATES],
                            dim=-1),
            "Wh": torch.cat([params[f"W_h{g}"] for g in ConvLSTM.GATES],
                            dim=-1),
            "W_ci": params["W_ci"],
            "W_cf": params["W_cf"],
            "W_co": params["W_co"],
        }

    @staticmethod
    def step_precomputed(fused: dict, carry: tuple[torch.Tensor, torch.Tensor],
                         gx: torch.Tensor, compute_dtype=None
                         ) -> tuple[tuple[torch.Tensor, torch.Tensor],
                                    torch.Tensor]:
        """One step given the precomputed input-side conv `gx` (4U
        channels). Only the state conv remains sequential."""
        c, h = carry
        units = fused["W_ci"].shape[-1]
        g = gx + conv2d(h, fused["Wh"], compute_dtype=compute_dtype)
        gi, gf, gc, go = torch.split(g, units, dim=-1)
        i = torch.sigmoid(gi + fused["W_ci"] * c)
        f = torch.sigmoid(gf + fused["W_cf"] * c)
        new_c = f * c + i * torch.tanh(gc)
        o = torch.sigmoid(go + fused["W_co"] * c)  # old c, like the reference
        new_h = torch.tanh(new_c) * o
        return (new_c, new_h), new_h

    @staticmethod
    def step(fused: dict, carry: tuple[torch.Tensor, torch.Tensor],
             x: torch.Tensor, compute_dtype=None
             ) -> tuple[tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
        gx = conv2d(x, fused["Wx"], compute_dtype=compute_dtype)
        return ConvLSTM.step_precomputed(fused, carry, gx,
                                         compute_dtype=compute_dtype)

    @staticmethod
    def zero_state(batch: int, spatial: tuple[int, int], num_units: int, *,
                   device=None, dtype=torch.float32
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        shape = (batch, spatial[0], spatial[1], num_units)
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))

    @staticmethod
    def input_gates(fused: dict, x_tbhwc: torch.Tensor,
                    compute_dtype=None) -> torch.Tensor:
        """The hoisted input-side conv for all T*B frames as ONE batched
        conv: [T, B, H, W, C] -> [T, B, H, W, 4U] in the compute dtype."""
        t, b = x_tbhwc.shape[:2]
        gx = conv2d(x_tbhwc.reshape(t * b, *x_tbhwc.shape[2:]), fused["Wx"],
                    compute_dtype=compute_dtype, out_dtype=compute_dtype)
        return gx.reshape(t, b, *gx.shape[1:])

    @staticmethod
    def scan_precomputed(fused: dict, gx_all: torch.Tensor,
                         carry0: tuple[torch.Tensor, torch.Tensor],
                         compute_dtype=None
                         ) -> tuple[tuple[torch.Tensor, torch.Tensor],
                                    torch.Tensor]:
        """The recurrence over precomputed input gates gx_all
        [T, B, H, W, 4U] -> ((c_T, h_T), ys [T, B, H, W, U]): the plain
        version of exactly what the CUDA kernel computes."""
        count("recurrence.plain_steps", len(gx_all))
        carry = carry0
        ys = []
        for gx in gx_all:
            carry, y = ConvLSTM.step_precomputed(fused, carry, gx,
                                                 compute_dtype=compute_dtype)
            ys.append(y)
        return carry, torch.stack(ys)

    @staticmethod
    def scan(params, x_tbhwc: torch.Tensor,
             carry0: tuple[torch.Tensor, torch.Tensor], compute_dtype=None
             ) -> tuple[tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
        """Run over time-major inputs [T, B, H, W, C] -> ((c_T, h_T),
        outputs [T, B, H, W, U]). The input-side conv is hoisted out of
        the loop; only the state conv stays sequential."""
        fused = ConvLSTM.fuse(params)
        gx_all = ConvLSTM.input_gates(fused, x_tbhwc, compute_dtype)
        return ConvLSTM.scan_precomputed(fused, gx_all, carry0, compute_dtype)


class FlatGRU:
    """TF `tf.nn.rnn_cell.GRUCell` semantics (reference `gaze_rnn.py:315`):

        [r, u] = sigmoid([x, h] @ W_gates + b_gates)   # b_gates init 1.0
        c      = tanh([x, r * h] @ W_cand + b_cand)
        h'     = u * h + (1 - u) * c

    The gate split is [r, u], reset first, as TF's.
    """

    @staticmethod
    def init(dim_input: int, num_units: int, *,
             generator: Optional[torch.Generator] = None) -> dict:
        return {
            "gates_kernel": init.orthogonal(
                (dim_input + num_units, 2 * num_units), generator=generator),
            "gates_bias": init.constant(1.0, (2 * num_units,)),
            "candidate_kernel": init.orthogonal(
                (dim_input + num_units, num_units), generator=generator),
            "candidate_bias": init.zeros((num_units,)),
        }

    @staticmethod
    def step(params, h: torch.Tensor, x: torch.Tensor,
             compute_dtype=None) -> tuple[torch.Tensor, torch.Tensor]:
        units = h.shape[-1]
        gates = torch.sigmoid(linear(torch.cat([x, h], dim=-1),
                                     params["gates_kernel"],
                                     params["gates_bias"],
                                     compute_dtype=compute_dtype))
        r, u = gates.split(units, dim=-1)
        c = torch.tanh(linear(torch.cat([x, r * h], dim=-1),
                              params["candidate_kernel"],
                              params["candidate_bias"],
                              compute_dtype=compute_dtype))
        new_h = u * h + (1.0 - u) * c
        return new_h, new_h

    @staticmethod
    def zero_state(batch: int, num_units: int, *, device=None,
                   dtype=torch.float32) -> torch.Tensor:
        return torch.zeros((batch, num_units), dtype=dtype, device=device)

    @staticmethod
    def scan(params, x_tbc: torch.Tensor, h0: torch.Tensor,
             compute_dtype=None) -> tuple[torch.Tensor, torch.Tensor]:
        """Time-major inputs [T, B, D] -> (final_h, ys [T, B, U]). The
        kernels' input rows (x @ W[:D]) run for all T at once; only the
        state rows (h @ W[D:]) stay on the sequential path."""
        t, b, d = x_tbc.shape
        units = h0.shape[-1]
        gk, ck = params["gates_kernel"], params["candidate_kernel"]
        flat_x = x_tbc.reshape(t * b, d)
        gx_all = linear(flat_x, gk[:d], params["gates_bias"],
                        compute_dtype=compute_dtype).reshape(t, b, -1)
        cx_all = linear(flat_x, ck[:d], params["candidate_bias"],
                        compute_dtype=compute_dtype).reshape(t, b, -1)
        h = h0
        ys = []
        for gx, cx in zip(gx_all, cx_all):
            gates = torch.sigmoid(gx + linear(h, gk[d:],
                                              compute_dtype=compute_dtype))
            r, u = gates.split(units, dim=-1)
            c = torch.tanh(cx + linear(r * h, ck[d:],
                                       compute_dtype=compute_dtype))
            h = u * h + (1.0 - u) * c
            ys.append(h)
        return h, torch.stack(ys)
