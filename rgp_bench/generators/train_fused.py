"""Training from raw video through the frozen C3D tower, as
`cli.train_fused` trains (`train.fused.fit_fused`'s step and batches).

The traffic file gives the `batch` of uint8 videos of `frames` frames at
the configuration's `video_hw`, the `clips` of a seeded host pool
(`weights.videos`, with positive random gaze maps of the T =
`pipeline_timesteps(frames)` steps; enough that the checked steps read
videos that all differ), `check_steps` (the first steps, which the
reference follows), `warmup_steps` after them, and `log_every` (the loss
read back every that many steps).

Set-up makes the gaze head's and the tower's weights from the seed, builds
the model, one train state (`train.state.create_train_state`, Adam per the
configuration) and `pipeline.make_fused_train_step` with the tower frozen
in the configuration's `tower_precision["fused"]`. Each step takes the
pool's next batch (`train.fused.RawVideoDataset.next_batch`) and puts it
on the card with `data.prefetch.device_put_batch`, as `fit_fused` does;
the first `check_steps` steps keep the first step's gradient as Adam's
first moment holds it and the parameters after the last; the same state
then runs the window. The window's rate counts the videos (clips) of
every step issued before its deadline; it ends when the device has
finished them.

`correct`: the plain reference (`reference.fused_train`: the float32
tower, then `reference.train.steps`) runs the same first steps from the
same weights, videos and draws; the readings are `train_prefetch`'s.

variant "control": the reference in float8 (tower and head) in the
program's place; "half_batch", "double_grad", "unchanged": the reference
with that fault.
"""

from __future__ import annotations

import gc
import time

import torch

from rgp_bench import weights
from rgp_bench.cell import Context, Outcome
from rgp_bench.generators.train_prefetch import B1, _readings
from rgp_bench.profile import TRACE_SECONDS, Trace
from rgp_bench.reference import fused_train as ref_fused
from rgp_bench.reference import precision
from rgp_bench.reference import video as ref_video


def pool(cell, seed: int, device) -> dict:
    """The host pool: uint8 videos [N, F, H, W, 3] and positive gaze maps
    [N, T, 49, 49], drawn on `device`."""
    cfg, tr = cell.config, cell.traffic
    m = cfg["model"]
    n, f = tr["clips"], tr["frames"]
    t = ref_video.timesteps(f)
    video = weights.videos(seed, "train_videos",
                           (n, f, *cfg["c3d"]["video_hw"], 3), device)
    g = weights.generator(seed, "train_maps", device)
    maps = torch.rand((n, t, m["gazemap_height"], m["gazemap_width"]),
                      generator=g, device=device).add_(1e-3)
    return {"video": video.cpu().numpy(), "gazemaps": maps.cpu().numpy()}


def _checked(arrays: dict, batch: int, count: int, device) -> list:
    return [{k: torch.from_numpy(arrays[k][i * batch:(i + 1) * batch]).to(
        device) for k in ("video", "gazemaps")} for i in range(count)]


def _reference(cell, seed: int, device, arrays: dict, variant: str,
               count: int) -> dict:
    cfg = cell.config
    params = {n: p.clone() for n, p in weights.head(cfg, seed,
                                                    device).items()}
    return ref_fused.steps(
        cfg, weights.tower(cfg, seed, device), params,
        _checked(arrays, cell.traffic["batch"], count, device),
        weights.generator(seed, "train", device),
        rounding=precision.fp8 if variant == "control" else None,
        fault=None if variant in ("program", "control") else variant)


def _loop(step, state, data, put, gen, until: float, batch: int,
          log_every: int) -> tuple:
    """Steps until `until`, then wait for the device -> (state, steps)."""
    done = 0
    while time.perf_counter() < until:
        state, metrics = step(state, put(data.next_batch(batch)), gen)
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
    from recurrent_gaze_prediction_tpu_torch.data.prefetch import (
        device_put_batch)
    from recurrent_gaze_prediction_tpu_torch.models import pipeline
    from recurrent_gaze_prediction_tpu_torch.train.fused import (
        FusedTrainState, RawVideoDataset)
    from recurrent_gaze_prediction_tpu_torch.train.state import (
        create_train_state)

    cfg, tr = cell.config, cell.traffic
    b, f, checked = tr["batch"], tr["frames"], tr["check_steps"]
    t = ref_video.timesteps(f)
    if tr["clips"] < checked * b:
        raise ValueError("the checked steps need videos that all differ")
    t0 = time.perf_counter()
    arrays = pool(cell, seed, device)
    notes = {"setup_data_s": time.perf_counter() - t0}
    shapes = {"batch": b, "timesteps": t, "frames": f,
              "clips": b * (f // ref_video.WINDOW), "model": cfg["model"],
              "cell": cfg["cell"], "c3d_channels": cfg["c3d"]["channels"],
              "crop": cfg["c3d"]["crop"]}
    window_s, n, trace_summary, trace_units, peak = 0.0, 0, None, 0, 0
    window_start = time.perf_counter()

    if variant == "program":
        dev = torch.device(device)
        model = registry.build_model(ModelConfig(**cfg["model"]),
                                     device=device)
        model.load_state_dict(weights.head(cfg, seed, device))
        gaze_state, tx = create_train_state(
            model, OptimizerConfig(**cfg["optimizer"]))
        state = FusedTrainState(
            params=gaze_state.params,
            opt_state=pipeline.init_fused_opt_state(tx, gaze_state.params),
            c3d_params=weights.tower(cfg, seed, device))
        tower_dtype = getattr(torch, cfg["tower_precision"]["fused"])
        step = pipeline.make_fused_train_step(model, tx,
                                              compute_dtype=tower_dtype)
        data = RawVideoDataset(arrays["video"], arrays["gazemaps"],
                               [f"video{i}" for i in range(tr["clips"])])

        def put(batch: dict) -> dict:
            return device_put_batch(batch, dev)

        gen = weights.generator(seed, "train", device)
        losses = []
        for k in range(checked):
            state, metrics = step(state, put(data.next_batch(b)), gen)
            losses.append(metrics["loss"])
            if k == 0:
                grad1 = {name: (mu / (1 - B1)).cpu() for name, mu in
                         state.opt_state["mu"].items()}
        got = {"losses": [float(x) for x in losses], "grad1": grad1,
               "params": {name: p.detach().cpu().clone()
                          for name, p in state.params.items()}}
        notes["route"] = model.last_route
        for _ in range(tr["warmup_steps"]):
            state, metrics = step(state, put(data.next_batch(b)), gen)
        float(metrics["loss"])
        notes["setup_steps_s"] = time.perf_counter() - t0 - notes[
            "setup_data_s"]

        window_start = time.perf_counter()
        state, n = _loop(step, state, data, put, gen,
                         window_start + seconds, b, tr["log_every"])
        window_s = time.perf_counter() - window_start
        if trace:
            profile = Trace()
            profile.start()
            state, trace_units = _loop(
                step, state, data, put, gen,
                time.perf_counter() + min(seconds, TRACE_SECONDS), b,
                tr["log_every"])
            trace_summary = profile.stop()
        if dev.type == "cuda":
            peak = torch.cuda.max_memory_allocated(device)
        del state, gaze_state, model, step, tx, data
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    else:
        got = _reference(cell, seed, device, arrays, variant, checked)

    want = _reference(cell, seed, device, arrays, "program", checked)
    readings, gaps = _readings(got, want, weights.head(cfg, seed, device))
    notes.update(gaps)
    context = Context(cell=cell, window_s=window_s, units=n, shapes=shapes,
                      spans={}, trace=trace_summary, trace_units=trace_units)
    e2e = {"train_clips_per_s": b * n / window_s} if window_s > 0 else {}
    return Outcome(attempted=checked + tr["warmup_steps"] + n + trace_units
                   if variant == "program" else checked, failed=0,
                   end_to_end=e2e, readings=readings,
                   memory_peak_bytes=int(peak), window_start=window_start,
                   context=context, notes=notes)
