"""The training loop: the port's counterpart of the JAX package's
`train/loop.py` (the reference's `ModelBase.fit`, `models/base.py:330-358`).

One train step per iteration, on batches copied inline or taken from a
`train_iterator` (the CLI's prefetch thread, `data/prefetch.py`);
checkpoint, validation-loss and evaluation cadences; auto-resume from the
latest checkpoint at start (`base.py:341-342`); a checkpoint-and-stop on
SIGTERM/SIGINT; per-step timing logs matching the reference's `sec/batch,
instances/sec` line (`models/gaze_rnn.py:547-563`); an optional profiler
window of `profile_steps` train steps (`train/profiler.py`).

With a `mesh` (`parallel.make_mesh`) every rank runs this loop on its
rows of each batch: the data-parallel step, validation and evaluation
split over the mesh, the state placed on it (and restored onto it from a
checkpoint of any topology). Rank 0 alone logs and writes metrics and
checkpoints. The loss is read back from the card only at the log cadence
(and at the end of the profiler window), so the host runs ahead of the
card in between.
"""

from __future__ import annotations

import signal
import time
from typing import Callable, Iterator, Optional

import torch

from ..config import ExperimentConfig
from ..data.datasets import DataSplits
from ..data.prefetch import device_put_batch, stream_casts
from ..eval import evaluator
from ..models.common import GazeModel
from ..utils import log
from . import profiler
from .checkpoint import Checkpointer
from .state import (Optimizer, TrainState, build_schedule, make_eval_step,
                    make_predict_fn, make_train_step)


def input_dtype_of(model: GazeModel) -> Optional[torch.dtype]:
    """The dtype the two big input streams (frames, c3d) are cast to on
    the host: bf16 under a bf16 compute dtype, halving their copy (the
    models cast them to it anyway); None otherwise. Loss targets stay
    f32."""
    return torch.bfloat16 if model.cfg.compute_dtype == "bfloat16" else None


def fit(model: GazeModel, state: TrainState, tx: Optimizer, data: DataSplits,
        exp: ExperimentConfig, *, train_dir: Optional[str] = None,
        metric_writer: Optional[Callable[[int, dict], None]] = None,
        max_eval_instances: int = 50,
        train_iterator: Optional[Iterator[dict]] = None,
        profile_steps: int = 0, profile_start: int = 3, mesh=None,
        model_parallel: Optional[bool] = None) -> TrainState:
    """Train until `exp.schedule.max_steps`; returns the final state. The
    flip and dropout draw from one generator on the model's device, seeded
    with `exp.seed`.

    Batches come from `train_iterator` when given (dicts of tensors or
    arrays, e.g. `data.prefetch.prefetch_batches`; the loop stops with a
    warning when it runs dry), else from `data.train.next_batch`, copied
    inline. Every `steps_per_evaluation` steps the saliency metrics of
    `generate_and_evaluate` on up to `max_eval_instances` clips of
    `data.valid` go to `metric_writer` as `evaluation/<metric>`.

    `profile_steps > 0` traces that many train steps into
    `{train_dir}/profile` (`train/profiler.py`), from the first step past
    `profile_start` (after the warm-up steps); a resumed run past it
    traces its first steps.

    `mesh` runs the loop over the mesh's ranks (every rank calls `fit`
    with the same arguments): the batch splits over "data" (batch_size
    must divide by its size; `train_iterator` may yield this rank's shards,
    `data.prefetch.prefetch_batches(mesh=...)`), `model_parallel` (None:
    when the mesh has a model axis) splits the wide products' weights, and
    only rank 0 logs and writes. `metric_writer` is read on rank 0 only."""
    sched_cfg = exp.schedule
    batch_size = model.cfg.batch_size
    lr_schedule = build_schedule(exp.optimizer)
    lead = mesh is None or mesh.rank == 0
    if mesh is not None:
        from ..parallel import (make_sharded_predict, make_sharded_train_step,
                                place_state, shard_batch)
        from ..parallel.sharding import make_sharded_eval_step

        if exp.optimizer.accum_steps > 1:
            raise NotImplementedError(
                "gradient accumulation + mesh sharding are not composed in "
                "fit(); shard the batch (data_parallel) OR accumulate, "
                "not both")
        if batch_size % mesh.data != 0:
            raise ValueError(
                f"batch_size {batch_size} must be divisible by the mesh "
                f"data axis ({mesh.data})")
        place_state(state, mesh, model_parallel)
        train_step = make_sharded_train_step(model, tx, mesh,
                                             model_parallel=model_parallel)
        eval_step = make_sharded_eval_step(model, mesh)
        predict_fn = make_sharded_predict(model, mesh,
                                          model_parallel=model_parallel)
        device = mesh.device

        def put(batch: dict, cast=None) -> dict:
            return shard_batch(batch, mesh, cast)
        # every rank must take the same branches around the collectives
        metric_writer = metric_writer if lead else None
        dump_images = mesh.broadcast_object(hasattr(metric_writer, "images"))
    else:
        train_step = make_train_step(model, tx,
                                     accum_steps=exp.optimizer.accum_steps)
        eval_step = make_eval_step(model)
        predict_fn = make_predict_fn(model)
        device = next(model.parameters()).device
        dump_images = hasattr(metric_writer, "images")

        def put(batch: dict, cast=None) -> dict:
            return device_put_batch(batch, device, cast)
    generator = torch.Generator(device=device).manual_seed(exp.seed)

    ckpt = None
    if train_dir is not None:
        ckpt = Checkpointer(train_dir, mesh=mesh)
        ckpt.save_config(exp)
        if ckpt.restore_latest(state) is not None:
            if lead:
                log.info(" [Checkpoint] resumed at step %d", state.step)
        elif lead:
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
    n_train = max(len(data.train), 1) if data.train is not None else 1
    input_dtype = input_dtype_of(model)
    cast = stream_casts(input_dtype)
    step = state.step
    last_logged_step, t_logged = step, time.time()
    trace = None      # the open profiler, between its start and stop
    profile_end = 0   # the last step to trace; nonzero once armed
    if profile_steps and train_dir is None and lead:
        log.warn("profile_steps=%d requested but train_dir is unset; "
                 "profiling disabled", profile_steps)
    try:
        stop = False  # under a mesh, agreed by the ranks at each log
        while step < sched_cfg.max_steps and not stop:
            # arm once at the first step past profile_start (>=, not ==: a
            # resumed run enters with step >> profile_start)
            if (profile_steps and train_dir is not None and profile_end == 0
                    and lead and step + 1 >= profile_start):
                trace = profiler.start_trace(f"{train_dir}/profile")
                profile_end = step + profile_steps
                log.info("profiler: tracing steps %d..%d -> %s/profile",
                         step + 1, profile_end, train_dir)
            if train_iterator is not None:
                raw = next(train_iterator, None)
                if raw is None:
                    if lead:
                        log.warn("train iterator exhausted at step %d", step)
                    break
                batch = (put(raw) if mesh is not None else
                         {k: torch.as_tensor(v, device=device)
                          for k, v in raw.items() if k != "clipnames"})
            else:
                batch = put(data.train.next_batch(batch_size), cast)
            state, metrics = train_step(state, batch, generator)
            step = state.step

            if trace is not None and step >= profile_end:
                float(metrics["loss"])  # the traced steps finish on the card
                trace.stop()
                trace = None

            stop = stop_requested["flag"]
            if mesh is not None:
                stop = (step % sched_cfg.steps_per_logprint == 0
                        and mesh.any_rank(stop))
            if step % sched_cfg.steps_per_logprint == 0:
                loss = float(metrics["loss"])  # the card syncs HERE
                t1 = time.time()
                sec_per_batch = (t1 - t_logged) / max(step - last_logged_step,
                                                      1)
                last_logged_step, t_logged = step, t1
                lr = lr_schedule(step)
                if lead:
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
                raw_valid = data.valid.next_batch(batch_size)
                vbatch = put(raw_valid, cast)
                vloss = float(eval_step(vbatch)["loss"])
                if lead:
                    log.infov(" [val   step %4d] loss: %.5f", step, vloss)
                if metric_writer:
                    metric_writer(step, {"loss/val": vloss})
                if dump_images:
                    # the last timestep, like the reference's validation
                    # dumps (gaze_rnn.py:172-208, max_outputs=2); under a
                    # mesh every rank predicts, rank 0 writes
                    preds = predict_fn(vbatch["frames"], vbatch["c3d"])
                    whole = (vbatch if mesh is None else
                             device_put_batch(raw_valid, torch.device("cpu")))
                    for tag, maps in (("inputimage", whole["frames"]),
                                      ("saliency_maps_gt", whole["gazemaps"]),
                                      ("saliency_maps_pred_norm", preds)):
                        if metric_writer:
                            metric_writer.images(
                                step, tag, maps[:, -1].float().cpu().numpy())

            if has_valid and step % sched_cfg.steps_per_evaluation == 0:
                _, scores = evaluator.generate_and_evaluate(
                    predict_fn, data.valid, batch_size,
                    max_instances=max_eval_instances, input_cast=input_dtype,
                    device=device, mesh=mesh)
                if metric_writer:
                    metric_writer(step, {f"evaluation/{m}": s
                                         for m, s in scores.items()})

        if profile_steps and train_dir is not None and profile_end == 0 \
                and lead:
            log.warn("profile_steps=%d requested but no step ran past "
                     "profile_start=%d (max_steps=%d); nothing was traced",
                     profile_steps, profile_start, sched_cfg.max_steps)
        if ckpt is not None:
            ckpt.save(state)
    finally:
        # every exit path, an exception's too, closes an open trace (the
        # loop may end inside the window)
        if trace is not None:
            trace.stop()
        for sig, handler in prev_handlers.items():
            signal.signal(sig, handler)
    return state
