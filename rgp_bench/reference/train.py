"""The first steps of feature-fed training, plainly: the release's step
(half-batch horizontal flip, dropout on the projection and on the logits,
softmax cross-entropy, gradients by autograd in float32) then optax's
chain of a global-norm clip and Adam (b1 0.9, b2 0.999, eps 1e-8 outside
the root, the learning rate of the pre-increment count), with the
release's staircase decay of the learning rate.

The random draws come from one generator, in the order the step takes
them: a permutation of the batch whose first B // 2 rows flip, the
projection's keep mask [B * T * 49, P], the logits' keep mask
[B * T * 2401, 1], each `torch.rand(...) < keep_prob`.

`fault` plants one of the faults `correct` has to refuse: "half_batch"
(the loss's mean over the first half of the rows only), "double_grad"
(the first leaf's gradient doubled where it is produced), "unchanged"
(no update).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import head

B1, B2, EPS = 0.9, 0.999, 1e-8


def learning_rate(opt: dict, count: int) -> float:
    steps = count / opt["decay_steps"]
    if opt["staircase"]:
        steps = float(int(steps))
    return opt["initial_learning_rate"] * opt["learning_rate_decay"] ** steps


def draws(batch: int, frames: int, proj: int, keep: float,
          generator: torch.Generator) -> tuple:
    """(rows to flip [B] bool, projection mask, logits mask), the masks
    scaled by 1 / keep."""
    dev = generator.device
    perm = torch.randperm(batch, generator=generator, device=dev)
    flip = torch.zeros(batch, dtype=torch.bool, device=dev)
    flip[perm[:batch // 2]] = True
    m_proj = torch.rand((batch * frames * 49, proj), generator=generator,
                        device=dev) < keep
    m_out = torch.rand((batch * frames * 2401, 1), generator=generator,
                       device=dev) < keep
    return flip, m_proj.float() / keep, m_out.float() / keep


def steps(cfg: dict, params: dict, batches: list,
          generator: torch.Generator, *, rounding=None,
          fault: Optional[str] = None) -> dict:
    """Train `params` (float32 leaves by name, updated here) through
    `batches` ({"c3d", "gazemaps"} on the generator's device) -> {"losses",
    "grad1": the first step's clipped gradient, "params": the params after
    the last step}."""
    model, opt = cfg["model"], cfg["optimizer"]
    keep = model["dropout_keep_prob"]
    names = list(params)
    mu = {n: torch.zeros_like(p) for n, p in params.items()}
    nu = {n: torch.zeros_like(p) for n, p in params.items()}
    losses, grad1 = [], None
    for count, batch in enumerate(batches):
        c3d, gaze = batch["c3d"].float(), batch["gazemaps"].float()
        b, t = c3d.shape[:2]
        flip, m_proj, m_out = draws(b, t, model["dim_cnn_proj"], keep,
                                    generator)
        if model["use_flip_batch"]:
            c3d = torch.where(flip[:, None, None, None, None],
                              c3d.flip(4), c3d)
            gaze = torch.where(flip[:, None, None, None], gaze.flip(3), gaze)
        leaves = {n: p.detach().clone().requires_grad_() for n, p in
                  params.items()}
        z = head.logits(leaves, cfg["cell"], c3d, rounding=rounding,
                        masks=(m_proj, m_out))
        rows = slice(0, b // 2) if fault == "half_batch" else slice(0, b)
        loss = head.xentropy(z[rows], gaze[rows])
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
        lr = learning_rate(opt, count)
        with torch.no_grad():
            for n in names:
                mu[n].mul_(B1).add_(grads[n], alpha=1 - B1)
                nu[n].mul_(B2).add_(grads[n].square(), alpha=1 - B2)
                m_hat = mu[n] / (1 - B1 ** (count + 1))
                v_hat = nu[n] / (1 - B2 ** (count + 1))
                params[n] = params[n] - lr * m_hat / (v_hat.sqrt() + EPS)
    return {"losses": losses, "grad1": grad1, "params": params}
