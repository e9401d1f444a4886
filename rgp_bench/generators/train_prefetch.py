"""Feature-fed training through the trainer's prefetch thread.

The traffic file gives the `batch`, the `clips` of a seeded in-RAM
`ClipDataset` (enough that the checked steps read rows that all differ),
the prefetch queue's `buffer` and host `cast` (the trainer's bf16 cast of
frames and features into pinned memory), `check_steps` (the first steps,
which the reference follows), `warmup_steps` after them, and `log_every`
(the trainer reads the loss back every that many steps, as
`cli.train_gaze` logs it).

Set-up builds one train state and step (`train.state.make_train_step`:
the ConvGRU's kernels forward and backward, Adam) on the seed's weights,
starts `data.prefetch.prefetch_batches` over the dataset, and drives the
first `check_steps` steps through them, keeping the first step's gradient
as the optimizer holds it (Adam's first moment / (1 - b1)) and the
parameters after the last; the same state and iterator then run the
window. The window's rate counts every step issued before its deadline;
it ends when the device has finished them.

`correct`: the plain reference runs the same first steps from the same
weights, batches and random draws (a generator seeded alike; the draws'
order is the step's) in float32, and the readings are the relative gap
of the first step's loss (`loss_gap`; the later steps' losses,
`loss_gap_later`, are reported beside it: Adam's first update moves every
weight by about the learning rate whatever its gradient's size, so the
signs that rounding picks for near-zero gradients move the later losses
in the program and in a float32 run alike), the worst leaf's gap between
the first gradients' norms (`grad_gap`) and between the norms of the
parameters' change over the checked steps (`change_gap`; leaves whose
reference gradient is under a thousandth of the median leaf's are left
out: their change is round-off, such as the logits' bias under the
softmax).

variant "control": the reference in float8 (e4m3, scaled per tensor) in
the program's place; "half_batch", "double_grad", "unchanged": the
reference with that fault (`reference.train`) in the program's place.
"""

from __future__ import annotations

import gc
import time

import torch

from rgp_bench import compare, weights
from rgp_bench.cell import Context, Outcome
from rgp_bench.profile import TRACE_SECONDS, Trace
from rgp_bench.reference import precision
from rgp_bench.reference import train as ref_train

B1 = 0.9  # Adam's first-moment decay, optax's and the program's default


def dataset_arrays(cell, seed: int, device) -> dict:
    """The clips as host arrays in the trainer's layout, drawn on `device`:
    frames [N,T,98,98,3] in [0, 1), conv5b-like features [N,T,1024,7,7]
    (relu of a normal, scaled), positive gaze maps, sparse fixations,
    pupils."""
    cfg, tr = cell.config, cell.traffic
    m = cfg["model"]
    n, t = tr["clips"], m["n_lstm_steps"]
    g = weights.generator(seed, "clips", device)
    gh, gw = m["gazemap_height"], m["gazemap_width"]

    def draw(shape, fn=torch.rand):
        return fn(shape, generator=g, device=device)

    arrays = {
        "c3d": draw((n, t, m["dim_feature"], 7, 7), torch.randn).relu_()
        .mul_(tr["feature_scale"]),
        "gazemaps": draw((n, t, gh, gw)).add_(1e-3),
        "fixationmaps": (draw((n, t, gh, gw)) < 2e-3).float(),
        "frames": draw((n, t, m["image_height"], m["image_width"], 3)),
        "pupils": draw((n, t)),
    }
    return {k: v.cpu().numpy() for k, v in arrays.items()}


def _checked_batches(arrays: dict, batch: int, count: int, device) -> list:
    return [{k: torch.from_numpy(arrays[k][i * batch:(i + 1) * batch]).to(
        device) for k in ("c3d", "gazemaps")} for i in range(count)]


def _reference(cell, seed: int, device, arrays: dict, variant: str,
               count: int) -> dict:
    params = {n: p.clone() for n, p in
              weights.head(cell.config, seed, device).items()}
    return ref_train.steps(
        cell.config, params, _checked_batches(
            arrays, cell.traffic["batch"], count, device),
        weights.generator(seed, "train", device),
        rounding=precision.fp8 if variant == "control" else None,
        fault=None if variant in ("program", "control") else variant)


def _readings(got: dict, want: dict, start: dict) -> tuple:
    """-> (the numbers compared, each leaf's gaps beside them)."""
    loss_gaps = [abs(a - b) / abs(b)
                 for a, b in zip(got["losses"], want["losses"])]
    g_got = {n: g.cpu() for n, g in got["grad1"].items()}
    g_want = {n: g.cpu() for n, g in want["grad1"].items()}
    grad = compare.leaf_gaps(g_got, g_want)
    diff = compare.leaf_diffs(g_got, g_want)
    norms = {n: float(g.double().norm()) for n, g in want["grad1"].items()}
    median = float(torch.tensor(list(norms.values())).median())
    moved = [n for n in norms if norms[n] >= 1e-3 * median]
    change = compare.leaf_gaps(
        {n: got["params"][n].cpu() - start[n].cpu() for n in moved},
        {n: want["params"][n].cpu() - start[n].cpu() for n in moved})
    readings = {"loss_gap": float(loss_gaps[0]),
                "loss_gap_later": float(max(loss_gaps[1:], default=0.0)),
                "grad_gap": max(grad.values()),
                "grad_diff": max(diff.values()),
                "change_gap": max(change.values())}
    notes = {"grad_gaps": grad, "grad_diffs": diff, "change_gaps": change,
             "left_out": sorted(set(norms) - set(moved))}
    return readings, notes


def _loop(step, state, batches, gen, until: float, log_every: int,
          spans: dict) -> tuple:
    """Steps until `until`, then wait for the device -> (state, steps)."""
    done = 0
    while time.perf_counter() < until:
        start = time.perf_counter()
        batch = next(batches)
        spans["input_wait_s"] += time.perf_counter() - start
        state, metrics = step(state, batch, gen)
        done += 1
        if done % log_every == 0:
            float(metrics["loss"])
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return state, done


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
              "cell": cfg["cell"]}
    spans = {"input_wait_s": 0.0}
    window_s, n, trace_summary, trace_units, peak = 0.0, 0, None, 0, 0
    window_start = time.perf_counter()

    if variant == "program":
        model = registry.build_model(ModelConfig(**cfg["model"]),
                                     device=device)
        model.load_state_dict(weights.head(cfg, seed, device))
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
        got = _reference(cell, seed, device, arrays, variant, checked)

    want = _reference(cell, seed, device, arrays, "program", checked)
    start = weights.head(cfg, seed, device)
    readings, gaps = _readings(got, want, start)
    notes.update(gaps)
    context = Context(cell=cell, window_s=window_s, units=n, shapes=shapes,
                      spans=spans, trace=trace_summary,
                      trace_units=trace_units)
    e2e = {"train_clips_per_s": b * n / window_s} if window_s > 0 else {}
    return Outcome(attempted=checked + tr["warmup_steps"] + n + trace_units
                   if variant == "program" else checked, failed=0,
                   end_to_end=e2e, readings=readings,
                   memory_peak_bytes=int(peak), window_start=window_start,
                   context=context, notes=notes)
