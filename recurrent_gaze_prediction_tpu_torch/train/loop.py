"""The training loop: the port's counterpart of the JAX package's
`train/loop.py` (the reference's `ModelBase.fit`, `models/base.py:330-358`).

One train step per iteration; checkpoint and validation-loss cadences;
auto-resume from the latest checkpoint at start (`base.py:341-342`); a
checkpoint-and-stop on SIGTERM/SIGINT; per-step timing logs matching the
reference's `sec/batch, instances/sec` line (`models/gaze_rnn.py:547-563`).

Not ported yet: the evaluation cadence (`steps_per_evaluation`, which needs
the evaluator, ROADMAP.md queue A item 4), image summaries, the profiler
window, and the mesh branch (item 6). The loss is read back from the card
only at the log cadence, so the host runs ahead of the card in between.
"""

from __future__ import annotations

import signal
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..config import ExperimentConfig
from ..data.datasets import DataSplits
from ..models.common import GazeModel
from ..utils import log
from .checkpoint import Checkpointer
from .state import (Optimizer, TrainState, build_schedule, make_eval_step,
                    make_train_step)


def device_batch(batch: dict, device: torch.device,
                 input_cast: Optional[torch.dtype] = None) -> dict:
    """A host batch as tensors on `device`. `input_cast` casts the two big
    input streams (frames, c3d) on the HOST first, halving the copy in
    bf16; the models cast them to the compute dtype anyway. Loss targets
    stay f32. Clip names and ragged object arrays (which no step reads)
    are dropped."""
    out = {}
    for key, value in batch.items():
        if key == "clipnames" or getattr(value, "dtype", None) == np.dtype(
                object):
            continue
        t = torch.from_numpy(np.ascontiguousarray(value))
        if input_cast is not None and key in ("frames", "c3d"):
            t = t.to(input_cast)
        out[key] = t.to(device)
    return out


def fit(model: GazeModel, state: TrainState, tx: Optimizer, data: DataSplits,
        exp: ExperimentConfig, *, train_dir: Optional[str] = None,
        metric_writer: Optional[Callable[[int, dict], None]] = None
        ) -> TrainState:
    """Train until `exp.schedule.max_steps` on batches of `data.train`;
    returns the final state. The flip and dropout draw from one generator
    on the model's device, seeded with `exp.seed`."""
    sched_cfg = exp.schedule
    batch_size = model.cfg.batch_size
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(exp.seed)
    lr_schedule = build_schedule(exp.optimizer)
    train_step = make_train_step(model, tx,
                                 accum_steps=exp.optimizer.accum_steps)
    eval_step = make_eval_step(model)

    ckpt = None
    if train_dir is not None:
        ckpt = Checkpointer(train_dir)
        ckpt.save_config(exp)
        if ckpt.restore_latest(state) is not None:
            log.info(" [Checkpoint] resumed at step %d", state.step)
        else:
            log.warn(" [Checkpoint] none found (starting from scratch)")

    stop_requested = {"flag": False}

    def _request_stop(signum, frame):
        del frame
        log.warn("signal %s received: checkpointing and stopping", signum)
        stop_requested["flag"] = True

    prev_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[sig] = signal.signal(sig, _request_stop)
        except ValueError:  # not the main thread
            pass

    has_valid = data.valid is not None and len(data.valid) >= batch_size
    if has_valid and sched_cfg.steps_per_evaluation <= sched_cfg.max_steps:
        log.warn("steps_per_evaluation=%d: the evaluation cadence is not "
                 "ported yet (needs the evaluator, ROADMAP.md queue A item "
                 "4); only the validation loss runs",
                 sched_cfg.steps_per_evaluation)
    n_train = max(len(data.train), 1)
    input_cast = (torch.bfloat16
                  if model.cfg.compute_dtype == "bfloat16" else None)
    step = state.step
    last_logged_step, t_logged = step, time.time()
    try:
        while step < sched_cfg.max_steps and not stop_requested["flag"]:
            batch = device_batch(data.train.next_batch(batch_size), device,
                                 input_cast)
            state, metrics = train_step(state, batch, generator)
            step = state.step

            if step % sched_cfg.steps_per_logprint == 0:
                loss = float(metrics["loss"])  # the card syncs HERE
                t1 = time.time()
                sec_per_batch = (t1 - t_logged) / max(step - last_logged_step,
                                                      1)
                last_logged_step, t_logged = step, t1
                lr = lr_schedule(step)
                log.info(
                    " [train epoch %.1f / step %4d] %s loss: %.5f "
                    "(%.3f sec/batch, %.3f instances/sec) (lr=%.3g)",
                    step * batch_size / n_train, step,
                    (exp.train_tag + " |" if exp.train_tag else ""),
                    loss, sec_per_batch,
                    batch_size / max(sec_per_batch, 1e-9), lr)
                if metric_writer:
                    metric_writer(step, {
                        "loss/train": loss,
                        "grad_norm": float(metrics["grad_norm"]),
                        "learning_rate": lr})

            if ckpt is not None and step % sched_cfg.steps_per_checkpoint == 0:
                ckpt.save(state)

            if has_valid and step % sched_cfg.steps_per_validation == 0:
                vbatch = device_batch(data.valid.next_batch(batch_size),
                                      device, input_cast)
                vloss = float(eval_step(vbatch)["loss"])
                log.infov(" [val   step %4d] loss: %.5f", step, vloss)
                if metric_writer:
                    metric_writer(step, {"loss/val": vloss})

        if ckpt is not None:
            ckpt.save(state)
    finally:
        for sig, handler in prev_handlers.items():
            signal.signal(sig, handler)
    return state
