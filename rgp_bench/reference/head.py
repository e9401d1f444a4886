"""The gaze models of the reference release (Yu et al., CVPR 2017), plainly:
GRU-RCN (`gaze_grcn`) and the peephole ConvLSTM (`gaze_lstm`).

    c3d [B, T, 1024, 7, 7] -> per position x @ proj_c3d_W + b (512),
      dropout -> the recurrent cell over T, 3x3 SAME convs, no biases,
      zero initial state -> per frame: frozen batch norm (mean 0, var 1,
      eps 1e-3), deconv 5x5 stride 3 VALID (64), deconv 5x5 stride 2
      VALID (32), deconv 7x7 stride 1 SAME (12), a 12 -> 1 linear head,
      dropout -> logits [B, T, 49, 49]; the maps are their softmax over the
      2401 positions.

GRU-RCN (Ballas et al., arXiv:1511.06432):
    u = sig(Wz*x + Uz*h), r = sig(Wr*x + Ur*h), c = tanh(W*x + U*(r h)),
    h' = u h + (1 - u) c.
Peephole ConvLSTM, as the release runs it (the candidate's state conv is
W_hc and the output gate reads the old cell state):
    i = sig(Wxi*x + Whi*h + Wci c), f = sig(Wxf*x + Whf*h + Wcf c),
    c' = f c + i tanh(Wxc*x + Whc*h), o = sig(Wxo*x + Who*h + Wco c),
    h' = tanh(c') o.
A deconvolution is the TensorFlow one: the input dilated by the stride,
padded, and correlated with the kernel (HWIO).

Weights are a dict under the names the release's variables have (the
benchmark's `weights.head`). `rounding(t)` rounds a contraction's operands
(the control's lower precision); `masks` holds the dropout masks, scaled
(kept elements 1 / keep_prob, dropped 0), in the order the training step
draws them.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from . import no_tf32

BN_EPS = 1e-3


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def conv_same(x: torch.Tensor, k: torch.Tensor, r: Callable) -> torch.Tensor:
    """NHWC x HWIO 3x3 SAME -> NHWC."""
    y = F.conv2d(r(x).permute(0, 3, 1, 2), r(k).permute(3, 2, 0, 1),
                 padding=k.shape[0] // 2)
    return y.permute(0, 2, 3, 1)


def deconv(x: torch.Tensor, k: torch.Tensor, stride: int, padding: str,
           r: Callable) -> torch.Tensor:
    """TensorFlow's conv2d_transpose as JAX's `lax.conv_transpose` defines
    it: NHWC x HWIO -> NHWC."""
    n, h, w, c = x.shape
    ks = k.shape[0]
    if stride > 1:
        d = x.new_zeros((n, (h - 1) * stride + 1, (w - 1) * stride + 1, c))
        d[:, ::stride, ::stride] = x
        x = d
    if padding == "VALID":
        lo = ks - 1
        hi = stride - 1 + max(ks - stride, 0)
    elif stride == 1 and ks % 2:  # SAME
        lo = hi = (ks - 1) // 2
    else:
        raise ValueError("the decoder has SAME deconvs of odd size, stride 1")
    xp = F.pad(r(x).permute(0, 3, 1, 2), (lo, hi, lo, hi))
    return F.conv2d(xp, r(k).permute(3, 2, 0, 1)).permute(0, 2, 3, 1)


def project(w: dict, c3d: torch.Tensor, r: Callable,
            mask: Optional[torch.Tensor]) -> torch.Tensor:
    """[B, T, F, 7, 7] -> [B, T, 7, 7, P]; rows in (b, t, y, x) order."""
    b, t, f = c3d.shape[:3]
    rows = c3d.reshape(b * t, f, -1).transpose(1, 2).reshape(-1, f)
    p = r(rows.float()) @ r(w["c3d_proj.proj_c3d_W"]) + w[
        "c3d_proj.proj_c3d_b"]
    if mask is not None:
        p = p * mask
    return p.reshape(b, t, 7, 7, -1)


def gru(w: dict, xs: torch.Tensor, r: Callable) -> torch.Tensor:
    """xs [B, T, 7, 7, P] -> hidden states [B, T, 7, 7, U]."""
    b, t = xs.shape[:2]
    units = w["cell.U"].shape[-1]
    h = xs.new_zeros((b, 7, 7, units))
    out = []
    for i in range(t):
        x = xs[:, i]
        u = torch.sigmoid(conv_same(x, w["cell.W_z"], r)
                          + conv_same(h, w["cell.U_z"], r))
        g = torch.sigmoid(conv_same(x, w["cell.W_r"], r)
                          + conv_same(h, w["cell.U_r"], r))
        c = torch.tanh(conv_same(x, w["cell.W"], r)
                       + conv_same(g * h, w["cell.U"], r))
        h = u * h + (1.0 - u) * c
        out.append(h)
    return torch.stack(out, 1)


def lstm(w: dict, xs: torch.Tensor, r: Callable) -> torch.Tensor:
    """xs [B, T, 7, 7, P] -> hidden states [B, T, 7, 7, U]."""
    b, t = xs.shape[:2]
    units = w["cell.W_hc"].shape[-1]
    h = xs.new_zeros((b, 7, 7, units))
    c = torch.zeros_like(h)
    out = []
    for i in range(t):
        x = xs[:, i]

        def pre(g):
            return (conv_same(x, w[f"cell.W_x{g}"], r)
                    + conv_same(h, w[f"cell.W_h{g}"], r))

        gi = torch.sigmoid(pre("i") + w["cell.W_ci"] * c)
        gf = torch.sigmoid(pre("f") + w["cell.W_cf"] * c)
        go = torch.sigmoid(pre("o") + w["cell.W_co"] * c)
        c = gf * c + gi * torch.tanh(pre("c"))
        h = torch.tanh(c) * go
        out.append(h)
    return torch.stack(out, 1)


def decode(w: dict, hs: torch.Tensor, r: Callable,
           mask: Optional[torch.Tensor]) -> torch.Tensor:
    """hidden states [N, 7, 7, U] -> logits [N, 49, 49]."""
    x = (hs * (w["decoder.bn_scale"] / (1.0 + BN_EPS) ** 0.5)
         + w["decoder.bn_offset"])
    x = deconv(x, w["decoder.up1_w"], 3, "VALID", r)
    x = deconv(x, w["decoder.up2_w"], 2, "VALID", r)
    x = deconv(x, w["decoder.up3_w"], 1, "SAME", r)            # [N,49,49,12]
    logits = (r(x) @ r(w["decoder.out_W"]))[..., 0] + w["decoder.out_b"]
    if mask is not None:
        logits = logits * mask.reshape(logits.shape)
    return logits


def logits(w: dict, cell: str, c3d: torch.Tensor, *,
           rounding: Optional[Callable] = None,
           masks: Optional[list] = None) -> torch.Tensor:
    """c3d [B, T, F, 7, 7] -> logits [B, T, 49, 49] float32. `masks`: the
    projection's and the decoder's keep masks (training), or None."""
    r = rounding or _same
    m_proj, m_dec = masks if masks is not None else (None, None)
    b, t = c3d.shape[:2]
    with no_tf32():
        xs = project(w, c3d, r, m_proj)
        hs = (gru if cell == "convgru" else lstm)(w, xs, r)
        out = decode(w, hs.reshape(b * t, 7, 7, -1), r, m_dec)
    return out.reshape(b, t, 49, 49)


def maps(w: dict, cell: str, c3d: torch.Tensor, *,
         rounding: Optional[Callable] = None) -> torch.Tensor:
    """The predicted gaze maps [B, T, 49, 49]: softmax over 2401
    positions."""
    z = logits(w, cell, c3d, rounding=rounding)
    return torch.softmax(z.reshape(*z.shape[:2], -1), -1).reshape(z.shape)


def xentropy(z: torch.Tensor, gazemaps: torch.Tensor) -> torch.Tensor:
    """The release's loss: softmax cross-entropy per frame against the
    ground-truth map normalized to sum 1, summed over T, averaged over
    B * T."""
    b, t = z.shape[:2]
    gt = gazemaps.reshape(b, t, -1).float()
    gt = gt / gt.sum(-1, keepdim=True)
    logp = torch.log_softmax(z.reshape(b, t, -1), -1)
    return -(gt * logp).sum() / (b * t)
