"""Shared building blocks of the gaze models: the port's counterpart of the
JAX package's `models/common.py`.

  * the C3D projection: [B,T,1024,7,7] -> [B,T,7,7,P], one
    [B*T*49, 1024] x [1024, P] product;
  * the frozen-BN 3-deconv decoder 7->23->49->49 with a 12->1 head, in
    both forms: stagewise, and composed into one [49*C, 2401] matrix;
  * `sequence_loss` (summed over T, averaged over B*T or the valid frames);
  * `GazeModel`: the `nn.Module` base with `predict` and `loss`.

Frame-wise work (projection, decoder) runs with T folded into the batch.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig
from ..ops import initializers as init
from ..ops.layers import (conv2d_transpose, dropout, frozen_batch_norm,
                          linear, matmul_f32)
from ..ops.normalize import (kl_divergence_2d, normalize_probability_map,
                             softmax_2d, softmax_cross_entropy_2d)


def compute_dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


# ------------------------------------------------------------------ C3D in

def init_c3d_projection(dim_feature: int, dim_proj: int, *,
                        generator: Optional[torch.Generator] = None) -> dict:
    return {
        "proj_c3d_W": init.uniform_scale((dim_feature, dim_proj), 0.1,
                                         generator=generator),
        "proj_c3d_b": init.uniform_scale((dim_proj,), 0.1,
                                         generator=generator),
    }


def apply_c3d_projection(params, c3d: torch.Tensor, *, keep_prob: float,
                         generator: Optional[torch.Generator], train: bool,
                         compute_dtype=None) -> torch.Tensor:
    """[B,T,1024,7,7] -> [B,T,7,7,dim_proj] with dropout. Casts to the
    compute dtype FIRST, then swaps (C, HW), then one matmul."""
    b, t, c = c3d.shape[:3]
    xb = c3d.reshape(b * t, c, 49)
    if compute_dtype is not None:
        xb = xb.to(compute_dtype)
    flat = xb.transpose(1, 2).reshape(-1, c)  # [B*T*49, C]
    proj = linear(flat, params["proj_c3d_W"], params["proj_c3d_b"],
                  compute_dtype=compute_dtype, out_dtype=compute_dtype)
    proj = dropout(proj, keep_prob, generator, deterministic=not train)
    return proj.reshape(b, t, 7, 7, -1)


# ----------------------------------------------------------------- decoder

def init_decoder(in_channels: int, with_batch_norm: bool = True, *,
                 generator: Optional[torch.Generator] = None) -> dict:
    """3-deconv upsampling decoder params (`gaze_grcn.py:292-314`)."""
    g = generator
    params = {
        "up1_w": init.xavier_uniform((5, 5, in_channels, 64), generator=g),
        "up2_w": init.xavier_uniform((5, 5, 64, 32), generator=g),
        "up3_w": init.xavier_uniform((7, 7, 32, 12), generator=g),
        "out_W": init.uniform_scale((12, 1), 0.1, generator=g),
        "out_b": init.uniform_scale((1,), 0.1, generator=g),
    }
    if with_batch_norm:
        params["bn_scale"] = torch.ones((in_channels,))
        params["bn_offset"] = torch.zeros((in_channels,))
    return params


def apply_decoder_stagewise(params, x: torch.Tensor, *, keep_prob: float,
                            generator: Optional[torch.Generator],
                            train: bool, compute_dtype=None) -> torch.Tensor:
    """The decoder as the reference wrote it: deconv 5x5/s3 VALID -> 23,
    deconv 5x5/s2 VALID -> 49, deconv 7x7/s1 SAME with the 12->1 head
    folded into its kernel."""
    if "bn_scale" in params:
        x = frozen_batch_norm(x, params["bn_scale"], params["bn_offset"])
    x = conv2d_transpose(x, params["up1_w"], stride=3, padding="VALID",
                         compute_dtype=compute_dtype, out_dtype=compute_dtype)
    x = conv2d_transpose(x, params["up2_w"], stride=2, padding="VALID",
                         compute_dtype=compute_dtype, out_dtype=compute_dtype)
    w_eff = torch.einsum("hwio,oj->hwij", params["up3_w"], params["out_W"])
    x = conv2d_transpose(x, w_eff, stride=1, padding="SAME",
                         compute_dtype=compute_dtype)
    n = x.shape[0]
    out = x.reshape(-1, 1) + params["out_b"].to(x.dtype)
    out = dropout(out, keep_prob, generator, deterministic=not train)
    return out.reshape(n, 49, 49)


def decoder_matrix(params) -> tuple[torch.Tensor, torch.Tensor]:
    """Compose the WHOLE decoder into one [7*7*C, 49*49] matrix and a
    [49*49] bias map, differentiably, in f32.

    The decoder has no nonlinearity: frozen BN -> deconv(5,s3) ->
    deconv(5,s2) -> deconv(7,s1,SAME) -> 12->1 head is one linear map from
    [7,7,C] to [49,49]. With the scatter-flipped-kernel deconvs,
    deconv(K, s) is y[o] = sum_i x[i] * Kf[o - s*i], Kf = flip(K); the two
    strided deconvs compose into E[J] = sum_j K1f[j] * K2f[J - 2*j]
    (J < 13), and the SAME k7 head on top gives
    out[q] = sum_i x[i] * G[q - 6*i + 3], G[g] = sum_v E[g + v - 6] * w_eff[v]
    (g < 19), in each spatial axis.
    """
    c_in = params["up1_w"].shape[2]
    w_eff = torch.einsum("hwio,oj->hwij", params["up3_w"], params["out_W"])

    # E: zero-upsample flip(up1) by 2, then correlate with up2, pad 4 -> 13
    k1f = params["up1_w"].flip(0, 1)                    # [5, 5, C, 64]
    up = k1f.new_zeros((9, 9) + tuple(k1f.shape[2:]))
    up[::2, ::2] = k1f                                  # [9, 9, C, 64]
    e = F.conv2d(up.permute(2, 3, 0, 1),                # C as the batch
                 params["up2_w"].permute(3, 2, 0, 1), padding=4)
    # G: correlate E with w_eff, pad 6 -> 19
    g = F.conv2d(e, w_eff.permute(3, 2, 0, 1), padding=6)  # [C, 1, 19, 19]
    g = g[:, 0].permute(1, 2, 0)                        # [19, 19, C]

    # M[i, q] = G[q - 6*i + 3] (0 outside) = P[q + 36 - 6*i] with
    # P[j] = G[j - 33] zero-padded: per (i_r, i_c) one shifted window
    p = F.pad(g, (0, 0, 33, 33, 33, 33))                # [85, 85, C]
    blocks = torch.stack([
        torch.stack([p[36 - 6 * ir:85 - 6 * ir, 36 - 6 * ic:85 - 6 * ic, :]
                     for ic in range(7)])
        for ir in range(7)])                            # [7, 7, 49, 49, C]
    m = blocks.permute(0, 1, 4, 2, 3)                   # [i_r,i_c,C,q_r,q_c]

    # fold the frozen BN affine (x*scale*rsqrt(1+eps) + offset) into M
    bias = params["out_b"].float()[0]
    if "bn_scale" in params:
        offset_map = torch.tensordot(params["bn_offset"].to(m.dtype),
                                     m.sum(dim=(0, 1)), dims=([0], [0]))
        scale = params["bn_scale"].to(m.dtype) * torch.rsqrt(
            torch.tensor(1.0 + 1e-3, dtype=m.dtype, device=m.device))
        m = m * scale[None, None, :, None, None]
        bias = bias + offset_map.reshape(-1)
    return m.reshape(7 * 7 * c_in, 49 * 49), bias


def apply_decoder_composed(params, x: torch.Tensor, *, keep_prob: float,
                           generator: Optional[torch.Generator], train: bool,
                           compute_dtype=None) -> torch.Tensor:
    """The decoder as ONE dense [N, 49*C] x [49*C, 2401] product."""
    m, bias = decoder_matrix(params)
    n = x.shape[0]
    out = matmul_f32(x.reshape(n, -1), m, compute_dtype) + bias
    out = dropout(out.reshape(-1, 1), keep_prob, generator,
                  deterministic=not train)
    return out.reshape(n, 49, 49)


# Below this many folded frames the per-call composition of the decoder
# matrix costs more than the decoder work itself, so small N (single-clip
# predicts, streaming chunks) takes the stagewise deconvs (the crossover
# the JAX package measured; not re-measured on the H100 yet).
_COMPOSE_MIN_N = 32


def apply_decoder(params, x: torch.Tensor, *, keep_prob: float,
                  generator: Optional[torch.Generator], train: bool,
                  compute_dtype=None) -> torch.Tensor:
    """[N, 7, 7, C] -> [N, 49, 49], N = B*T folded. The two forms are equal
    up to float reassociation."""
    fn = (apply_decoder_stagewise if x.shape[0] < _COMPOSE_MIN_N
          else apply_decoder_composed)
    return fn(params, x, keep_prob=keep_prob, generator=generator,
              train=train, compute_dtype=compute_dtype)


# ------------------------------------------------------------------ losses

def sequence_loss(logits: torch.Tensor, gt_gazemap: torch.Tensor,
                  loss_type: str,
                  frame_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-frame loss summed over time, averaged by B*T.

    l2: 0.5 * sum of squares; xentropy: softmax cross-entropy over the
    flattened H*W grid; kld: KL(gt || softmax(pred)). `frame_mask` [B, T]
    (1 = real frame, 0 = padding) drops padded frames and normalizes by
    the valid frame count.
    """
    b, t = logits.shape[:2]
    if frame_mask is None:
        denom = float(b * t)
        weight = None
    else:
        weight = frame_mask.float()
        denom = torch.clamp(weight.sum(), min=1.0)

    if loss_type == "l2":
        per_frame = 0.5 * (logits - gt_gazemap).square().sum(dim=(-2, -1))
    elif loss_type == "xentropy":
        per_frame = softmax_cross_entropy_2d(logits, gt_gazemap)
    elif loss_type == "kld":
        per_frame = kl_divergence_2d(softmax_2d(logits), gt_gazemap)
    else:
        raise NotImplementedError(loss_type)
    if weight is not None:
        per_frame = per_frame * weight
    return per_frame.sum() / denom


# ----------------------------------------------------------------- harness

class GazeModel(nn.Module):
    """Base of the gaze models. `forward(frames, c3d, train=...)` returns
    raw per-frame logits [B, T, GH, GW]; `predict` post-processes them to
    probability maps when the loss is xentropy/kld."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg

    def forward(self, frames, c3d: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        raise NotImplementedError

    def loss(self, batch: dict, *, train: bool = True,
             generator: Optional[torch.Generator] = None
             ) -> tuple[torch.Tensor, dict]:
        logits = self(batch.get("frames"), batch["c3d"], train=train,
                      generator=generator)
        gt = batch["gazemaps"]
        if self.cfg.loss_type in ("xentropy", "kld"):
            gt = normalize_probability_map(gt)
        loss = sequence_loss(logits, gt, self.cfg.loss_type,
                             frame_mask=batch.get("frame_mask"))
        return loss, {"logits": logits}

    @torch.inference_mode()
    def predict(self, frames, c3d: torch.Tensor) -> torch.Tensor:
        logits = self(frames, c3d, train=False)
        if self.cfg.loss_type in ("xentropy", "kld"):
            return softmax_2d(logits)
        return logits
