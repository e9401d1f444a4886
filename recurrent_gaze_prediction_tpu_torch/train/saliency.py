"""Standalone ShallowNet training, the SALICON pretraining stage: the port's
counterpart of the JAX package's `train/saliency.py` (reference
`SaliencyModel` training, `models/saliency_shallownet.py:219-366`).

The loss is the l2 target loss normalized by 49*49 and the batch, plus the
1e-7 weight-decay regularizer over the model's variables; half the batch
is flipped horizontally; dropout keeps 0.4. The optimizer is Adam after a
global-norm clip (`max_grad_norm <= 0`: no clip), the port's `Optimizer`.
The trained params go to a params-only file (`checkpoint.save_params`)
that grafts into the gaze models (`checkpoint.restore_shallownet`).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..config import OptimizerConfig
from ..models import shallownet
from ..utils import log, resolve_device
from .state import Optimizer, build_schedule, random_half_flip

DROPOUT_KEEP = 0.4  # saliency_shallownet.py:330


def saliency_loss(params, images: torch.Tensor, gt_maps: torch.Tensor, *,
                  generator: Optional[torch.Generator] = None,
                  train: bool = False,
                  dropout_keep_prob: float = DROPOUT_KEEP,
                  compute_dtype=None) -> tuple[torch.Tensor, dict]:
    """reg + sum((pred - gt)^2)/(49*49)/B (`saliency_shallownet.py:
    247-250`) -> (loss, {"target_loss", "reg_loss", "pred"})."""
    pred = shallownet.apply(params, images,
                            dropout_keep_prob=dropout_keep_prob,
                            generator=generator, train=train,
                            compute_dtype=compute_dtype)
    b = images.shape[0]
    target = (pred - gt_maps).square().sum() / (49.0 * 49.0) / b
    reg = shallownet.l2_regularizer(params)
    return reg + target, {"target_loss": target, "reg_loss": reg,
                          "pred": pred}


def make_saliency_train_step(opt_cfg: OptimizerConfig, compute_dtype=None,
                             use_flip: bool = True,
                             dropout_keep_prob: float = DROPOUT_KEEP
                             ) -> tuple[Callable, Optimizer]:
    """-> (step, tx). `step(params, opt_state, images, gt_maps, generator)
    -> metrics` updates `params` (a dict of tensors) and `opt_state`
    (`tx.init(params)`) in place; `generator` (on the params' device)
    draws the flip and the dropout masks (None when both are off).
    `metrics` holds device tensors: loss, target_loss, reg_loss."""
    max_norm = opt_cfg.max_grad_norm if opt_cfg.max_grad_norm > 0 else 0.0
    tx = Optimizer("adam", build_schedule(opt_cfg), max_norm)

    def step(params: dict, opt_state: dict, images: torch.Tensor,
             gt_maps: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> dict:
        if use_flip:
            flipped = random_half_flip({"images": images, "gt_maps": gt_maps},
                                       generator, {"images": 2, "gt_maps": 2})
            images, gt_maps = flipped["images"], flipped["gt_maps"]
        loss, aux = saliency_loss(params, images, gt_maps,
                                  generator=generator, train=True,
                                  dropout_keep_prob=dropout_keep_prob,
                                  compute_dtype=compute_dtype)
        grads = torch.autograd.grad(loss, list(params.values()))
        tx.apply(params, dict(zip(params, grads)), opt_state)
        return {"loss": loss.detach(),
                "target_loss": aux["target_loss"].detach(),
                "reg_loss": aux["reg_loss"].detach()}

    return step, tx


def fit_shallownet(dataset, *, opt_cfg: Optional[OptimizerConfig] = None,
                   max_steps: int = 1000, batch_size: int = 128,
                   seed: int = 0, compute_dtype=None, log_every: int = 50,
                   device=None,
                   metric_writer: Optional[Callable[[int, dict], None]] = None
                   ) -> dict:
    """Train ShallowNet on a SALICON-style dataset (`next_batch(n)` ->
    (images [n,98,98,3], maps [n,49,49], ...)) on `device` (None = the
    card); returns the trained params {name: tensor}. Every `log_every`
    steps the losses are logged and, when given, passed to
    `metric_writer(step, {"loss/train", "target_loss", "reg_loss"})`."""
    dev = resolve_device(device)
    opt_cfg = opt_cfg or OptimizerConfig(initial_learning_rate=3e-5,
                                         use_decay_schedule=False)
    params = {k: v.to(dev).requires_grad_()
              for k, v in shallownet.init_params(
                  generator=torch.Generator().manual_seed(seed)).items()}
    step_fn, tx = make_saliency_train_step(opt_cfg,
                                           compute_dtype=compute_dtype)
    opt_state = tx.init(params)
    generator = torch.Generator(device=dev).manual_seed(seed + 1)
    for i in range(max_steps):
        images, maps = dataset.next_batch(batch_size)[:2]
        images = torch.as_tensor(images, dtype=torch.float32).to(dev)
        maps = torch.as_tensor(maps, dtype=torch.float32).to(dev)
        metrics = step_fn(params, opt_state, images, maps, generator)
        if i % log_every == 0 or i == max_steps - 1:
            values = {"loss/train": float(metrics["loss"]),
                      "target_loss": float(metrics["target_loss"]),
                      "reg_loss": float(metrics["reg_loss"])}
            log.info(" [shallownet step %4d] loss: %.5f (target %.5f)", i,
                     values["loss/train"], values["target_loss"])
            if metric_writer is not None:
                metric_writer(i + 1, values)
    return {k: v.detach() for k, v in params.items()}
