"""Feature-fed training of the two-level ConvGRU cascade through the
trainer's prefetch thread: `train_prefetch`'s traffic (its dataset, loop
and readings) on the cascade's own weights and reference.

The traffic file's keys are `train_prefetch`'s. Set-up builds the model
with `registry.build_model` on the seed's weights (`weights_cascade`), one
train state with the ShallowNet group frozen
(`train.state.create_train_state`) and one step (`make_train_step`: both
cells on `ConvGRU.scan`, each step rematerialized under `remat_cells`;
Adam), starts `data.prefetch.prefetch_batches` over a seeded in-RAM
`ClipDataset` and drives the first `check_steps` steps, keeping the first
step's gradient as Adam's first moment holds it and the parameters after
the last; the same state and iterator then run the window.

`correct`: the plain reference (`reference.cascade`) runs the same first
steps from the same weights, batches and draws in float32; the readings
are `train_prefetch`'s (`grad_diff`, `grad_gap`, `change_gap`, with the
losses' gaps beside them) over the trained leaves. Beside them (not
compared), `frozen_change` in the notes: the largest change of a frozen
ShallowNet weight in the program, 0 when the group stays frozen.

variant "control": the reference in float8 in the program's place;
"half_batch", "double_grad", "unchanged": the reference with that fault.
"""

from __future__ import annotations

import gc
import time

import torch

from rgp_bench import weights, weights_cascade
from rgp_bench.cell import Context, Outcome
from rgp_bench.generators.train_prefetch import (B1, _checked_batches,
                                                 _loop, _readings,
                                                 dataset_arrays)
from rgp_bench.profile import TRACE_SECONDS, Trace
from rgp_bench.reference import cascade as ref_cascade
from rgp_bench.reference import precision


def _reference(cell, seed: int, device, arrays: dict, variant: str,
               count: int) -> dict:
    params = weights_cascade.params(cell.config, seed, device)
    return ref_cascade.steps(
        cell.config, params, _checked_batches(
            arrays, cell.traffic["batch"], count, device),
        weights.generator(seed, "train", device), weights_cascade.frozen,
        rounding=precision.fp8 if variant == "control" else None,
        fault=None if variant in ("program", "control") else variant)


def run(cell, seed: int, seconds: float, trace: bool, device,
        variant: str = "program") -> Outcome:
    from recurrent_gaze_prediction_tpu_torch import registry
    from recurrent_gaze_prediction_tpu_torch.config import (ModelConfig,
                                                            OptimizerConfig)
    from recurrent_gaze_prediction_tpu_torch.data.datasets import ClipDataset
    from recurrent_gaze_prediction_tpu_torch.data.prefetch import (
        prefetch_batches, stream_casts)
    from recurrent_gaze_prediction_tpu_torch.train.state import (
        create_train_state, make_train_step)

    cfg, tr = cell.config, cell.traffic
    b, t, checked = tr["batch"], cfg["model"]["n_lstm_steps"], tr[
        "check_steps"]
    if tr["clips"] < checked * b:
        raise ValueError("the checked steps need rows that all differ")
    t0 = time.perf_counter()
    arrays = dataset_arrays(cell, seed, device)
    notes = {"setup_data_s": time.perf_counter() - t0}
    shapes = {"batch": b, "timesteps": t, "model": cfg["model"],
              "cascade": cfg["cascade"], "cell": cfg["cell"]}
    spans = {"input_wait_s": 0.0}
    window_s, n, trace_summary, trace_units, peak = 0.0, 0, None, 0, 0
    window_start = time.perf_counter()
    start = weights_cascade.params(cfg, seed, device)
    frozen = {name: p.cpu() for name, p in start.items()
              if weights_cascade.frozen(name)}
    frozen_change = 0.0

    if variant == "program":
        model = registry.build_model(ModelConfig(**cfg["model"]),
                                     device=device)
        model.load_state_dict(start)
        del start
        state, tx = create_train_state(model,
                                       OptimizerConfig(**cfg["optimizer"]))
        step = make_train_step(model, tx)
        data = ClipDataset(**arrays, clipnames=[
            f"clip{i}" for i in range(tr["clips"])])
        cast = stream_casts(getattr(torch, tr["cast"]) if tr["cast"]
                            else None)
        batches = prefetch_batches(data, b, device=device,
                                   buffer_size=tr["buffer"], cast=cast)
        gen = weights.generator(seed, "train", device)
        losses = []
        for k in range(checked):
            state, metrics = step(state, next(batches), gen)
            losses.append(metrics["loss"])
            if k == 0:
                grad1 = {name: (mu / (1 - B1)).cpu() for name, mu in
                         state.opt_state["mu"].items()}
        got = {"losses": [float(x) for x in losses], "grad1": grad1,
               "params": {name: p.detach().cpu().clone()
                          for name, p in state.params.items()}}
        frozen_change = max(float((got["params"][name] - p).abs().max())
                            for name, p in frozen.items())
        notes["route"] = model.last_route
        for _ in range(tr["warmup_steps"]):
            state, metrics = step(state, next(batches), gen)
        float(metrics["loss"])
        notes["setup_steps_s"] = time.perf_counter() - t0 - notes[
            "setup_data_s"]

        window_start = time.perf_counter()
        state, n = _loop(step, state, batches, gen, window_start + seconds,
                         tr["log_every"], spans)
        window_s = time.perf_counter() - window_start
        if trace:
            wait = spans["input_wait_s"]
            profile = Trace()
            profile.start()
            state, trace_units = _loop(
                step, state, batches, gen,
                time.perf_counter() + min(seconds, TRACE_SECONDS),
                tr["log_every"], spans)
            trace_summary = profile.stop()
            spans["input_wait_s"] = wait
        if torch.device(device).type == "cuda":
            peak = torch.cuda.max_memory_allocated(device)
        batches.close()
        del batches, state, model, step, tx, data
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    else:
        del start
        got = _reference(cell, seed, device, arrays, variant, checked)

    want = _reference(cell, seed, device, arrays, "program", checked)
    start = {name: p for name, p in weights_cascade.params(
        cfg, seed, device).items() if name in want["grad1"]}
    readings, gaps = _readings(got, want, start)
    notes.update(gaps, frozen_change=frozen_change)
    context = Context(cell=cell, window_s=window_s, units=n, shapes=shapes,
                      spans=spans, trace=trace_summary,
                      trace_units=trace_units)
    e2e = {"train_clips_per_s": b * n / window_s} if window_s > 0 else {}
    return Outcome(attempted=checked + tr["warmup_steps"] + n + trace_units
                   if variant == "program" else checked, failed=0,
                   end_to_end=e2e, readings=readings,
                   memory_peak_bytes=int(peak), window_start=window_start,
                   context=context, notes=notes)
