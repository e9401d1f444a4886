"""Hollywood2 13-class multi-label action classification with optional gaze
attention: the port's counterpart of the JAX package's
`action/classification.py` (the reference's `Classifier`,
`models/action_classification.py`).

  * gaze attention (`action_classification.py:210-240`): gazemap [49,49]
    -> flatten -> [2401, 49] projection -> broadcast over the 1024 C3D
    channels -> elementwise product with c3d reshaped [1024, 49]
  * SVM head (`:242-263`): zero-init linear [50176, 13], loss =
    0.5*||W||^2 + svmC(=50) * hinge, plain SGD lr 0.01
  * NN head (`:265-292`): fc 50176 -> 256 -> 256 -> 13 (glorot, no relu in
    the reference), sigmoid cross-entropy, Adam with exp-decay lr
    (0.002, decay 0.96 every 10 steps, smooth)
  * evaluation (`:526-579`): Hamming loss, zero-one subset accuracy,
    per-class + mean average precision, in NumPy

The parameters are a flat dict of f32 tensors under the JAX package's
names and layouts ([in, out] matrices), so `params_from_jax` carries its
weights over unchanged. Everything computes in f32, as the JAX package
does; on the card the matmuls run with TF32 off. They are plain matrix
products, computed by the JAX package outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Callable, Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..bridge import params_from_jax as _bridge_params
from ..ops import initializers as init
from ..ops.layers import linear
from ..train import schedules
from ..train.state import Optimizer
from ..utils import resolve_device, tf32_off

NUM_CLASSES = 13
C3D_FLAT = 1024 * 49
BATCH_KEYS = ("c3d", "gaze_pred", "labels")


@dataclasses.dataclass
class ActionHParams:
    """`create_standard_hparams` equivalent
    (`action_classification.py:50-71`)."""

    batch_size: int = 10
    num_classes: int = NUM_CLASSES
    max_iter: int = 2001
    learning_rate: float = 0.002
    use_gazemap: bool = False
    head: str = "NN"         # NN | SVM
    svm_c: float = 50.0
    # False replicates the reference hinge EXACTLY
    # (`action_classification.py:252-253` feeds the {0,1} multi-hot raw, so
    # absent classes contribute a constant 1 with zero gradient: the SVM
    # never learns to suppress them). True (default) is the JAX package's
    # signed-label fix.
    svm_signed_labels: bool = True
    n_hidden: int = 256
    seed: int = 0


def init_params(hp: ActionHParams,
                generator: Optional[torch.Generator] = None, *,
                device=None) -> dict:
    """The JAX package's parameters (names, shapes, init recipes), drawn
    on the CPU from `generator`, on `device` (None = the card), each with
    requires_grad."""
    dev = resolve_device(device)
    params = {}
    if hp.use_gazemap:
        # the reference's 'normal' init (`basic_graphs.py:105-106`):
        # truncated normal, stddev 0.05
        params["gaze_proj_W"] = init.truncated_normal(
            (2401, 49), stddev=0.05, generator=generator)
    if hp.head == "SVM":
        params["svm_W"] = init.zeros((C3D_FLAT, hp.num_classes))
        params["svm_b"] = init.zeros((hp.num_classes,))
    else:
        params["h1_w"] = init.xavier_uniform((C3D_FLAT, hp.n_hidden),
                                             generator=generator)
        params["h1_b"] = init.zeros((hp.n_hidden,))
        params["h2_w"] = init.xavier_uniform((hp.n_hidden, hp.n_hidden),
                                             generator=generator)
        params["h2_b"] = init.zeros((hp.n_hidden,))
        params["out_w"] = init.xavier_uniform((hp.n_hidden, hp.num_classes),
                                              generator=generator)
        params["out_b"] = init.zeros((hp.num_classes,))
    return {k: v.to(dev).requires_grad_() for k, v in params.items()}


def params_from_jax(tree: Mapping, device=None) -> dict:
    """The JAX package's classifier parameters (numpy or jax arrays) -> the
    port's dict on `device` (None = the card), each with requires_grad."""
    dev = resolve_device(device)
    return {k: v.float().to(dev).requires_grad_()
            for k, v in _bridge_params(tree).items()}


def project(params: dict, c3d: torch.Tensor, gazemap: Optional[torch.Tensor],
            use_gazemap: bool) -> torch.Tensor:
    """[B, 1024, 7, 7] (+ [B, 49, 49]) -> [B, 50176]
    (`action_classification.py:210-240`)."""
    b = c3d.shape[0]
    flat = c3d.reshape(b, 1024, 49)
    if use_gazemap:
        proj = linear(gazemap.reshape(b, -1), params["gaze_proj_W"])  # [B,49]
        flat = flat * proj[:, None, :]
    return flat.reshape(b, C3D_FLAT)


def logits_fn(params: dict, c3d: torch.Tensor,
              gazemap: Optional[torch.Tensor],
              hp: ActionHParams) -> torch.Tensor:
    x = project(params, c3d, gazemap, hp.use_gazemap)
    if hp.head == "SVM":
        return linear(x, params["svm_W"], params["svm_b"])
    h1 = linear(x, params["h1_w"], params["h1_b"])
    h2 = linear(h1, params["h2_w"], params["h2_b"])
    return linear(h2, params["out_w"], params["out_b"])


def loss_fn(params: dict, batch: dict, hp: ActionHParams) -> torch.Tensor:
    gaze = batch.get("gaze_pred") if hp.use_gazemap else None
    logits = logits_fn(params, batch["c3d"], gaze, hp)
    labels = batch["labels"]
    if hp.head == "SVM":
        # the hinge needs SIGNED labels: fed the records' {0,1} multi-hot
        # raw, as the reference does (action_classification.py:253), an
        # absent class contributes max(0, 1-0) = 1 with zero gradient;
        # `svm_signed_labels=False` keeps that for strict A/B runs
        y = 2.0 * labels - 1.0 if hp.svm_signed_labels else labels
        reg = 0.5 * params["svm_W"].square().sum()
        hinge = torch.relu(1.0 - y * logits).sum()
        return reg + hp.svm_c * hinge
    return F.binary_cross_entropy_with_logits(logits, labels)


def predict_proba(params: dict, batch: dict,
                  hp: ActionHParams) -> torch.Tensor:
    gaze = batch.get("gaze_pred") if hp.use_gazemap else None
    logits = logits_fn(params, batch["c3d"], gaze, hp)
    if hp.head == "SVM":
        return logits  # margins
    return torch.sigmoid(logits)


class SGD:
    """`optax.sgd(lr)`: p <- p - lr * g, no momentum (the port's
    `train.Optimizer("sgd")` is the gaze trainer's momentum 0.9)."""

    def __init__(self, learning_rate: float):
        self.learning_rate = learning_rate

    def init(self, params: dict) -> dict:
        del params
        return {"count": 0}

    @torch.no_grad()
    def apply(self, params: dict, grads: dict, opt_state: dict) -> None:
        for name, p in params.items():
            p.add_(-self.learning_rate * grads[name])
        opt_state["count"] += 1


def make_optimizer(hp: ActionHParams):
    """SGD 0.01 for the SVM head; Adam on a smooth exponential decay of
    the learning rate (x0.96 per 10 steps) for the NN head."""
    if hp.head == "SVM":
        return SGD(0.01)
    return Optimizer("adam", schedules.exponential_decay(
        hp.learning_rate, 0.96, 10, staircase=False))


def make_train_step(hp: ActionHParams, tx) -> Callable:
    """step(params, opt_state, batch) -> loss: one update of `params` and
    `opt_state` in place, the loss of the batch it was computed on."""

    def step(params: dict, opt_state: dict, batch: dict) -> torch.Tensor:
        with tf32_off():
            loss = loss_fn(params, batch, hp)
            grads = torch.autograd.grad(loss, list(params.values()))
        tx.apply(params, dict(zip(params, grads)), opt_state)
        return loss.detach()

    return step


def batch_to(batch: dict, device: torch.device) -> dict:
    """The classifier's streams of a record batch as f32 tensors on
    `device`."""
    return {k: torch.as_tensor(np.asarray(v, np.float32)).to(
        device, non_blocking=True) for k, v in batch.items()
        if k in BATCH_KEYS}


class ActionClassifier:
    """The counterpart of the reference's `Classifier.run`
    (`action_classification.py:384-433`), on `device` (None = the
    card)."""

    def __init__(self, hp: Optional[ActionHParams] = None, *, device=None):
        self.hp = hp or ActionHParams()
        self.device = resolve_device(device)
        self.params = init_params(
            self.hp, torch.Generator().manual_seed(self.hp.seed),
            device=self.device)
        self.tx = make_optimizer(self.hp)
        self.opt_state = self.tx.init(self.params)
        self._step = make_train_step(self.hp, self.tx)

    def fit(self, batches: Iterable[dict]) -> list[float]:
        """Up to `max_iter` steps; the per-step losses, read back once at
        the end."""
        losses = []
        for i, batch in enumerate(batches):
            if i >= self.hp.max_iter:
                break
            losses.append(self._step(self.params, self.opt_state,
                                     batch_to(batch, self.device)))
        return torch.stack(losses).cpu().tolist() if losses else []

    def predict(self, batch: dict) -> np.ndarray:
        with torch.no_grad(), tf32_off():
            return predict_proba(self.params, batch_to(batch, self.device),
                                 self.hp).cpu().numpy()

    def save(self, path: str) -> None:
        """Params-only file (`train.save_params`)."""
        from ..train.checkpoint import save_params

        save_params(path, self.params)

    @classmethod
    def load(cls, path: str, hp: Optional[ActionHParams] = None, *,
             device=None) -> "ActionClassifier":
        from ..train.checkpoint import load_params

        clf = cls(hp, device=device)
        loaded = load_params(path)
        if set(loaded) != set(clf.params):
            raise ValueError(f"{path}: classifier params do not match: "
                             f"{sorted(loaded)} vs {sorted(clf.params)}")
        with torch.no_grad():
            for name, p in clf.params.items():
                p.copy_(loaded[name])
        clf.opt_state = clf.tx.init(clf.params)
        return clf


# --------------------------------------------------------------- metrics

def hamming_loss(y_true: np.ndarray, y_pred: np.ndarray,
                 threshold: float = 0.5) -> float:
    y_pred = (np.asarray(y_pred) >= threshold).astype(np.float32)
    return float(np.mean(np.asarray(y_true) != y_pred))


def zero_one_loss(y_true: np.ndarray, y_pred: np.ndarray,
                  threshold: float = 0.5) -> float:
    y_pred = (np.asarray(y_pred) >= threshold).astype(np.float32)
    exact = np.all(np.asarray(y_true) == y_pred, axis=-1)
    return float(1.0 - exact.mean())


def average_precision(y_true: np.ndarray, y_score: np.ndarray) -> np.ndarray:
    """Per-class AP (area under precision-recall, step interpolation)."""
    y_true = np.asarray(y_true)
    y_score = np.asarray(y_score)
    aps = []
    for c in range(y_true.shape[1]):
        t, s = y_true[:, c], y_score[:, c]
        if t.sum() == 0:
            aps.append(np.nan)
            continue
        order = np.argsort(-s)
        t = t[order]
        tp = np.cumsum(t)
        precision = tp / np.arange(1, len(t) + 1)
        aps.append(float((precision * t).sum() / t.sum()))
    return np.asarray(aps)


def evaluate(y_true: np.ndarray, y_score: np.ndarray,
             threshold: float = 0.5) -> dict:
    """`threshold` is the positive-class decision boundary: 0.5 for the
    NN head's sigmoid probabilities, 0.0 for the SVM head's raw margins
    (the reference thresholds SVM output with np.sign)."""
    aps = average_precision(y_true, y_score)
    return {
        "hamming_loss": hamming_loss(y_true, y_score, threshold),
        "zero_one_loss": zero_one_loss(y_true, y_score, threshold),
        "mean_average_precision": float(np.nanmean(aps)),
        "per_class_ap": aps,
    }
