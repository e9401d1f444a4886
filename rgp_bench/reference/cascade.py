"""The two-level coarse-to-fine GRU-RCN of the reference release
(`models/gaze_grcn_cascade.py:188-481`, Yu et al., CVPR 2017), its l2
loss and its first steps of training, plainly:

    c3d [B, T, 1024, 7, 7] -> per position x @ proj_c3d_W + b (512), no
      dropout -> bottom GRU-RCN over T: 3x3 SAME convs, 256 units, no
      biases, zero initial state, at 7x7 -> every step's state through one
      deconvolution 11x11 stride 7 SAME (64 channels) -> [49, 49, 64]
      -> top GRU-RCN over T: 5x5 SAME convs, 3 units, at 49x49 -> per
      frame: the state flattened (h, w, c) -> fc 7203 -> 4802, relu,
      dropout, maxout (the larger of the two halves) -> fc 2401 -> 4802,
      relu, maxout -> [49, 49]
    loss: 0.5 * the sum of squares of (map - ground truth) per frame,
      summed over T, averaged over B * T (the ground truth as it comes).

GRU-RCN: u = sig(Wz*x + Uz*h), r = sig(Wr*x + Ur*h),
c = tanh(W*x + U*(r h)), h' = u h + (1 - u) c. A deconvolution is the
TensorFlow one (as in `head.py`): the input dilated by the stride, padded
as TensorFlow pads SAME (k - 1 - the forward conv's pad on each side),
correlated with the kernel (HWIO).

Departures from the release, each shared with the JAX package and the
program:
  * the top cell takes the 64 upsampled channels where the release
    declares 65 (a latent shape bug there, `gaze_grcn_cascade.py:17-20`);
  * the frozen ShallowNet subtree is carried but feeds nothing (its concat
    is commented out, `gaze_grcn_cascade.py:370-377`), so it is not run;
  * the head runs time-major, rows in (t, b) order, which is the order the
    dropout mask is drawn in.

Training (`steps`) follows `train.py`: the half-batch horizontal flip of
the features (last axis) and maps, drawn first from the generator; then
the head's keep mask [T * B, 4802], `torch.rand(...) < keep_prob`;
gradients by autograd in float32; optax's global-norm clip over the
trained leaves and Adam with the release's staircase decay. The leaves
that `frozen(name)` names get no update and no moment, and are left out
of the clip's norm. `rounding` and `fault` are `train.py`'s.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from . import head, no_tf32, train

BOTTOM, TOP = "bottom_cell", "top_cell"
UP_STRIDE = 7   # the bottom cell's 7x7 grid to the 49x49 map


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def deconv_same(x: torch.Tensor, k: torch.Tensor, stride: int,
                r: Callable) -> torch.Tensor:
    """TensorFlow's SAME conv2d_transpose: NHWC [N, H, W, C] x HWIO ->
    [N, H * stride, W * stride, O]."""
    n, h, w, c = x.shape
    ks = k.shape[0]
    d = x.new_zeros((n, (h - 1) * stride + 1, (w - 1) * stride + 1, c))
    d[:, ::stride, ::stride] = x
    total = max((h - 1) * stride + ks - h * stride, 0)  # the forward's pad
    lo = ks - 1 - total // 2
    hi = ks - 1 - (total - total // 2)
    xp = F.pad(r(d).permute(0, 3, 1, 2), (lo, hi, lo, hi))
    return F.conv2d(xp, r(k).permute(3, 2, 0, 1)).permute(0, 2, 3, 1)


def gru(w: dict, cell: str, xs: torch.Tensor, r: Callable) -> torch.Tensor:
    """xs [T, B, H, W, C] -> hidden states [T, B, H, W, U] of the GRU-RCN
    whose kernels are `w[f"{cell}.W_z"]` etc."""
    def k(name):
        return w[f"{cell}.{name}"]

    units = k("U").shape[-1]
    h = xs.new_zeros((*xs.shape[1:4], units))
    out = []
    for x in xs:
        u = torch.sigmoid(head.conv_same(x, k("W_z"), r)
                          + head.conv_same(h, k("U_z"), r))
        g = torch.sigmoid(head.conv_same(x, k("W_r"), r)
                          + head.conv_same(h, k("U_r"), r))
        c = torch.tanh(head.conv_same(x, k("W"), r)
                       + head.conv_same(g * h, k("U"), r))
        h = u * h + (1.0 - u) * c
        out.append(h)
    return torch.stack(out)


def maxout(x: torch.Tensor) -> torch.Tensor:
    a, b = x.chunk(2, dim=-1)
    return torch.maximum(a, b)


def maps(w: dict, c3d: torch.Tensor, *, rounding: Optional[Callable] = None,
         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """c3d [B, T, F, 7, 7] -> maps [B, T, 49, 49] float32. `mask`: the
    head's scaled keep mask [T * B, 4802] (training), or None."""
    r = rounding or _same
    b, t = c3d.shape[:2]
    with no_tf32():
        xs = head.project(w, c3d, r, None).transpose(0, 1)   # [T,B,7,7,P]
        hs = gru(w, BOTTOM, xs, r)
        up = deconv_same(hs.reshape(t * b, *hs.shape[2:]), w["up_w"],
                         UP_STRIDE, r)
        gs = gru(w, TOP, up.reshape(t, b, *up.shape[1:]), r)
        x = torch.relu(r(gs.reshape(t * b, -1)) @ r(w["fc1_w"]) + w["fc1_b"])
        if mask is not None:
            x = x * mask
        x = maxout(x)
        x = maxout(torch.relu(r(x) @ r(w["fc2_w"]) + w["fc2_b"]))
    return x.reshape(t, b, 49, 49).transpose(0, 1)


def l2(z: torch.Tensor, gazemaps: torch.Tensor) -> torch.Tensor:
    """The release's l2 loss over [B, T, 49, 49] maps."""
    b, t = z.shape[:2]
    return 0.5 * (z - gazemaps.float()).square().sum() / (b * t)


def draws(batch: int, frames: int, width: int, keep: float,
          generator: torch.Generator) -> tuple:
    """(rows to flip [B] bool, the head's mask [T * B, width] scaled by
    1 / keep), in the order the training step draws them."""
    dev = generator.device
    perm = torch.randperm(batch, generator=generator, device=dev)
    flip = torch.zeros(batch, dtype=torch.bool, device=dev)
    flip[perm[:batch // 2]] = True
    m = torch.rand((frames * batch, width), generator=generator,
                   device=dev) < keep
    return flip, m.float() / keep


def steps(cfg: dict, params: dict, batches: list,
          generator: torch.Generator, frozen: Callable[[str], bool], *,
          rounding=None, fault: Optional[str] = None) -> dict:
    """Train `params` (float32 leaves by name, the trained ones updated
    here) through `batches` ({"c3d", "gazemaps"} on the generator's
    device) -> {"losses", "grad1": the first step's clipped gradient of
    each trained leaf, "params": every leaf after the last step}."""
    model, opt = cfg["model"], cfg["optimizer"]
    keep = model["dropout_keep_prob"]
    names = [n for n in params if not frozen(n)]
    mu = {n: torch.zeros_like(params[n]) for n in names}
    nu = {n: torch.zeros_like(params[n]) for n in names}
    losses, grad1 = [], None
    width = params["fc1_w"].shape[1]
    for count, batch in enumerate(batches):
        c3d, gaze = batch["c3d"].float(), batch["gazemaps"].float()
        b, t = c3d.shape[:2]
        flip, mask = draws(b, t, width, keep, generator)
        if model["use_flip_batch"]:
            c3d = torch.where(flip[:, None, None, None, None],
                              c3d.flip(4), c3d)
            gaze = torch.where(flip[:, None, None, None], gaze.flip(3), gaze)
        leaves = {n: params[n].detach().clone().requires_grad_()
                  for n in names}
        z = maps({**params, **leaves}, c3d, rounding=rounding, mask=mask)
        rows = slice(0, b // 2) if fault == "half_batch" else slice(0, b)
        loss = l2(z[rows], gaze[rows])
        grads = dict(zip(names, torch.autograd.grad(
            loss, [leaves[n] for n in names])))
        if fault == "double_grad":
            grads[names[0]] = grads[names[0]] * 2
        norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        if opt["max_grad_norm"] > 0 and norm >= opt["max_grad_norm"]:
            grads = {n: g / norm * opt["max_grad_norm"]
                     for n, g in grads.items()}
        if grad1 is None:
            grad1 = {n: g.detach().clone() for n, g in grads.items()}
        losses.append(float(loss.detach()))
        if fault == "unchanged":
            continue
        lr = train.learning_rate(opt, count)
        with torch.no_grad():
            for n in names:
                mu[n].mul_(train.B1).add_(grads[n], alpha=1 - train.B1)
                nu[n].mul_(train.B2).add_(grads[n].square(),
                                          alpha=1 - train.B2)
                m_hat = mu[n] / (1 - train.B1 ** (count + 1))
                v_hat = nu[n] / (1 - train.B2 ** (count + 1))
                params[n] = params[n] - lr * m_hat / (v_hat.sqrt()
                                                      + train.EPS)
    return {"losses": losses, "grad1": grad1, "params": params}
