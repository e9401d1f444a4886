"""Checkpoint-sweep evaluation: the port's counterpart of the JAX package's
`eval/sweep.py` (the reference's checkpoint-sweep wrappers,
`models/action_evaluation.py` and `models/evaluate_gaze.py:268-279`).
Evaluates every retained checkpoint of a run and reports per-step scores.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from ..data.datasets import ClipDataset
from ..registry import create_model
from ..train import Checkpointer, create_train_state, make_predict_fn
from ..utils import log, resolve_device
from . import evaluator


def sweep_checkpoints(train_dir: str, dataset: ClipDataset,
                      metrics: Sequence[str] = evaluator.AVAILABLE_METRICS,
                      max_instances: Optional[int] = 50,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> dict[int, dict]:
    """Evaluate every checkpoint step under `train_dir` on `device` (None =
    the card); returns {step: {metric: score}} and logs the best step by
    the first metric."""
    dev = resolve_device(device)
    exp = Checkpointer.load_config(train_dir)
    model = create_model(exp.model.name, exp.model, device=dev)
    state, _ = create_train_state(model, exp.optimizer)
    ckpt = Checkpointer(train_dir)
    predict = make_predict_fn(model)

    results: dict[int, dict] = {}
    for step in ckpt.steps():
        # the same data window for every checkpoint: a dataset's cursor
        # would otherwise make the per-checkpoint scores incomparable
        dataset.reset()
        ckpt.restore(step, state)
        _, scores = evaluator.generate_and_evaluate(
            predict, dataset, model.cfg.batch_size,
            max_instances=max_instances, metrics=metrics, device=dev)
        results[step] = scores
        log.infov("checkpoint %d: %s", step,
                  {m: round(s, 4) for m, s in scores.items()})

    if results:
        primary = list(metrics)[0]
        best = max(results, key=lambda s: results[s][primary])
        log.infov("best checkpoint by %s: step %d (%.4f)", primary, best,
                  results[best][primary])
    return results
