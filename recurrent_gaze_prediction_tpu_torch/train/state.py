"""Train state, the optimizer, and the train/eval steps: the port's
counterpart of the JAX package's `train/state.py`.

  * `Optimizer`: optax's `chain(clip_by_global_norm, adam | rmsprop(momentum
    .9) | sgd(momentum .9))` written out with optax's formulas, which differ
    from torch.optim's: Adam with eps 1e-8 outside the root and the learning
    rate of the pre-increment count (the first update uses lr(0)); RMSprop
    with decay 0.9, eps inside the root and the learning rate applied before
    the momentum trace; the clip scaling by max_norm / norm (no epsilon)
    when norm >= max_norm.
  * two parameter groups: a top-level `shallownet` subtree gets zero
    updates when frozen (reference `models/gaze_rnn.py:459-476`); the clip's
    norm covers the trained group only, as optax's `multi_transform` does.
    `create_train_state` freezes it by default only in a model that
    declares `has_shallownet` (gaze_rnn, gaze_grcn_cascade):
    gaze_framewise_shallownet's ShallowNet is the whole model and trains.
  * the LR schedule is a function of the update count, so resume restores
    the right LR.
  * the flip augmentation mirrors exactly floor(B/2) samples of the batch,
    chosen with an explicit `torch.Generator`, on the device.

The JAX package's `jax.random` keys become one `torch.Generator` on the
model's device, which draws the flip permutation and the dropout masks; the
two packages' random numbers differ, so the parity tests run with flip and
dropout off. The data-parallel step (`parallel/sharding.py`) shares the
optimizer, the flip and `loss_and_grads` with this one.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional

import torch

from ..config import OptimizerConfig
from ..models.common import GazeModel
from . import schedules
from .profiler import span


@dataclasses.dataclass
class TrainState:
    """`params` are the model's own parameters by name (updated in place),
    `opt_state` the optimizer's moments by the same names plus its update
    count, `step` the number of train steps taken."""

    params: dict
    opt_state: dict
    step: int = 0


def build_schedule(opt_cfg: OptimizerConfig) -> Callable[[int], float]:
    if opt_cfg.use_decay_schedule:
        return schedules.exponential_decay(
            opt_cfg.initial_learning_rate, opt_cfg.learning_rate_decay,
            opt_cfg.decay_steps, opt_cfg.staircase)
    return schedules.constant(opt_cfg.initial_learning_rate)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (optax.global_norm)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


class Optimizer:
    """optax's gradient transformation chain, applied in place.

    `opt_state` is {"count": int, "mu"/"nu"/"trace": {name: tensor}}: the
    moments that the method keeps (adam: mu, nu; rmsprop: nu, trace; sgd:
    trace), for the trained parameters only.
    """

    B1, B2, EPS = 0.9, 0.999, 1e-8       # optax.adam
    RMS_DECAY, MOMENTUM = 0.9, 0.9       # optax.rmsprop / sgd, momentum .9
    _MOMENTS = {"adam": ("mu", "nu"), "rmsprop": ("nu", "trace"),
                "sgd": ("trace",)}

    def __init__(self, method: str, schedule: Callable[[int], float],
                 max_grad_norm: float = 0.0, frozen: Iterable[str] = ()):
        if method not in self._MOMENTS:
            raise ValueError(f"Invalid optimization method: {method}")
        self.method = method
        self.schedule = schedule
        self.max_grad_norm = max_grad_norm
        self.frozen = set(frozen)

    def init(self, params: dict) -> dict:
        state = {"count": 0}
        for moment in self._MOMENTS[self.method]:
            state[moment] = {n: torch.zeros_like(p, dtype=torch.float32)
                             for n, p in params.items()
                             if n not in self.frozen}
        return state

    def trained(self, params: dict) -> list:
        """The names of the parameters this optimizer updates."""
        return [n for n in params if n not in self.frozen]

    @torch.no_grad()
    def apply(self, params: dict, grads: dict, opt_state: dict,
              norm: Optional[torch.Tensor] = None) -> None:
        """One update of `params` and `opt_state` from `grads`, in place.
        `norm` is the trained gradients' global norm when the caller has
        it (a model-split run sums it over the model group), else it is
        computed here."""
        names = self.trained(params)
        g = {n: grads[n].float() for n in names}
        if self.max_grad_norm > 0 and g:  # g is empty when all is frozen
            if norm is None:
                norm = global_norm(g.values())
            keep = norm < self.max_grad_norm
            g = {n: torch.where(keep, t, t / norm * self.max_grad_norm)
                 for n, t in g.items()}
        count = opt_state["count"]
        lr = self.schedule(count)
        for n in names:
            if self.method == "adam":
                mu, nu = opt_state["mu"][n], opt_state["nu"][n]
                mu.mul_(self.B1).add_(g[n], alpha=1 - self.B1)
                nu.mul_(self.B2).add_(g[n].square(), alpha=1 - self.B2)
                mu_hat = mu / (1 - self.B1 ** (count + 1))
                nu_hat = nu / (1 - self.B2 ** (count + 1))
                update = -lr * (mu_hat / (nu_hat.sqrt() + self.EPS))
            elif self.method == "rmsprop":
                nu, trace = opt_state["nu"][n], opt_state["trace"][n]
                nu.mul_(self.RMS_DECAY).add_(g[n].square(),
                                             alpha=1 - self.RMS_DECAY)
                trace.mul_(self.MOMENTUM).add_(
                    -lr * g[n] * torch.rsqrt(nu + self.EPS))
                update = trace
            else:  # sgd
                trace = opt_state["trace"][n]
                trace.mul_(self.MOMENTUM).add_(g[n])
                update = -lr * trace
            params[n].add_(update.to(params[n].dtype))
        opt_state["count"] = count + 1


def build_optimizer(opt_cfg: OptimizerConfig, params: dict,
                    freeze_shallownet: Optional[bool] = None) -> Optimizer:
    """The optimizer with the reference's two-group scheme: if the params
    have a top-level `shallownet` subtree and freezing is enabled, that
    group gets zero updates (`gaze_rnn.py:459`)."""
    freeze = (opt_cfg.freeze_shallownet
              if freeze_shallownet is None else freeze_shallownet)
    frozen = {n for n in params if n.split(".")[0] == "shallownet"} \
        if freeze else set()
    max_norm = opt_cfg.max_grad_norm if opt_cfg.max_grad_norm > 0 else 0.0
    return Optimizer(opt_cfg.method, build_schedule(opt_cfg), max_norm,
                     frozen)


def create_train_state(model: GazeModel, opt_cfg: OptimizerConfig,
                       freeze_shallownet: Optional[bool] = None
                       ) -> tuple[TrainState, Optimizer]:
    """The state of a fresh run on `model`'s parameters (the model was
    initialized from its generator when it was built). The `shallownet.*`
    group is frozen when `freeze_shallownet` is True, or when it is None
    and both `opt_cfg.freeze_shallownet` and `model.has_shallownet`
    hold."""
    params = dict(model.named_parameters())
    freeze = freeze_shallownet
    if freeze is None:
        freeze = opt_cfg.freeze_shallownet and model.has_shallownet
    tx = build_optimizer(opt_cfg, params, freeze_shallownet=freeze)
    return TrainState(params=params, opt_state=tx.init(params), step=0), tx


# ------------------------------------------------------------ augmentation

def random_half_flip(batch: dict, generator: torch.Generator,
                     axes: dict, shards: int = 1, shard: int = 0) -> dict:
    """Mirror a random half of the batch along per-key axes, on the device.

    `axes` maps batch key -> flip axis; keys absent from the batch are
    skipped. Exactly floor(B/2) samples flip, like the reference
    (`gaze_rnn.py:502-510`): the first B//2 entries of a random permutation
    drawn from `generator` (which lives on the batch's device).

    `batch` may be shard `shard` of `shards` equal row blocks of a global
    batch (a data-parallel rank's rows): the choice is drawn for the
    global batch, from a generator seeded alike on every rank, and the
    shard's rows of it are applied.
    """
    b = next(iter(batch.values())).shape[0]
    n = b * shards
    perm = torch.randperm(n, generator=generator, device=generator.device)
    flip = torch.zeros(n, dtype=torch.bool, device=generator.device)
    flip[perm[:n // 2]] = True
    flip = flip[shard * b:(shard + 1) * b]
    out = dict(batch)
    for key, axis in axes.items():
        if key in batch:
            x = batch[key]
            mask = flip.to(x.device).reshape((b,) + (1,) * (x.dim() - 1))
            out[key] = torch.where(mask, x.flip(axis), x)
    return out


FLIP_AXES = {"frames": 3, "gazemaps": 3, "c3d": 4, "fixationmaps": 3}


def flip_half_batch(batch: dict, generator: torch.Generator) -> dict:
    """Mirror a random half of the batch horizontally: frames [B,T,H,W,3]
    on W, gazemaps/fixationmaps [B,T,GH,GW] on W, and c3d [B,T,1024,7,7]
    on its last axis (`gaze_rnn.py:502-510`). Other keys (pupils [B,T], a
    scalar per frame) pass as they are."""
    return random_half_flip(batch, generator, FLIP_AXES)


# ------------------------------------------------------------------ steps

def loss_and_grads(model: GazeModel, params: dict, batch: dict,
                   generator: Optional[torch.Generator]
                   ) -> tuple[torch.Tensor, list]:
    """The train loss on `batch` (detached) and its gradient for each of
    `params` in order (zeros for a parameter it does not reach)."""
    with span("train.forward"):
        loss, _ = model.loss(batch, train=True, generator=generator)
    with span("train.backward"):
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if gr is None else gr
                           for p, gr in zip(params.values(), grads)]


def make_train_step(model: GazeModel, tx: Optimizer,
                    use_flip: Optional[bool] = None,
                    accum_steps: int = 1) -> Callable:
    """Returns `step(state, batch, generator) -> (state, metrics)`.

    `batch` holds tensors on the model's device; `generator` (on that
    device) draws the flip and the dropout masks, and may be None when both
    are off. `accum_steps > 1` splits the batch's leading axis into that
    many microbatches, averages their losses and gradients, and applies ONE
    optimizer update: the same mean-over-batch gradient at 1/accum_steps
    the activation memory. The batch size must divide evenly. `metrics`
    holds device tensors (`loss`, `grad_norm`) and the new `step`; reading
    them is the caller's synchronization point.
    """
    flip = model.cfg.use_flip_batch if use_flip is None else use_flip

    def step(state: TrainState, batch: dict,
             generator: Optional[torch.Generator] = None):
        with span("train.step", request=state.step + 1):
            return _step(state, batch, generator)

    def _step(state: TrainState, batch: dict,
              generator: Optional[torch.Generator]):
        if flip:
            with span("train.flip"):
                batch = flip_half_batch(batch, generator)
        if accum_steps == 1:
            loss, grads = loss_and_grads(model, state.params, batch,
                                         generator)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % accum_steps:
                raise ValueError(f"batch size {b} not divisible by "
                                 f"accum_steps {accum_steps}")
            micro = {k: v.reshape(accum_steps, b // accum_steps,
                                  *v.shape[1:]) for k, v in batch.items()}
            loss, grads = 0.0, None
            for i in range(accum_steps):
                mb_loss, mb_grads = loss_and_grads(
                    model, state.params, {k: v[i] for k, v in micro.items()},
                    generator)
                loss = loss + mb_loss
                grads = mb_grads if grads is None else [
                    a + g for a, g in zip(grads, mb_grads)]
            loss = loss / accum_steps
            grads = [g / accum_steps for g in grads]
        with span("train.optimizer"):
            named = dict(zip(state.params, grads))
            grad_norm = global_norm(grads)
            tx.apply(state.params, named, state.opt_state)
        state.step += 1
        return state, {"loss": loss, "grad_norm": grad_norm,
                       "step": state.step}

    return step


def make_eval_step(model: GazeModel) -> Callable:
    """Returns `eval_step(batch) -> {"loss"}` (validation loss, no
    dropout)."""

    @torch.no_grad()
    def eval_step(batch: dict) -> dict:
        loss, _ = model.loss(batch, train=False)
        return {"loss": loss}

    return eval_step


def make_predict_fn(model: GazeModel) -> Callable:
    """Returns `predict(frames, c3d) -> prob/logit maps`."""

    def predict(frames, c3d):
        return model.predict(frames, c3d)

    return predict
