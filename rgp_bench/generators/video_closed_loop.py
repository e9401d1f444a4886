"""Raw-video gaze extraction through a served bundle program, closed loop.

The traffic file gives the served `program` ("fused_int8": the int8 tower
on kernel Q1; "fused": the bf16 tower), the request (`batch` uint8 videos
of `frames` frames at the configuration's `video_hw`), a pool of
`pool_batches` seeded requests, `callers` threads each of which sends its
next request only when its maps are back, and `calib_windows` seeded
16-frame windows for the int8 tower's calibration.

Set-up makes the weights from the seed, builds the program's model, writes
the bundle with `save_bundle` under $TMPDIR (the int8 calibration
included), reads it back with `load_bundle`, makes the pool and warms the
program on it. A request is the bundle program called on a uint8 video in
host memory (it uploads the video itself) and its maps read back with
`.cpu().numpy()`, as `serving/server.py` does. Its latency runs from that
call to the maps in host memory.

`correct`: once the window has closed and the program is freed, the plain
reference computes the maps of `reference_rows` rows of every pool batch,
drawn from the seed; those rows of every request of the window (and of the
traced window) are compared with them: `map_gap`, the largest L1
distance between a served map and the reference's, over `map_spread`, the
mean L1 distance between the reference's maps of two different videos at
one timestep. So a reading is the error as a share of how far apart the
maps of two videos lie: an answer for the wrong video reads about 1, and
a run's weights that make the maps more or less sensitive to their input
scale the error and the spread alike. `map_gap_mean` (the mean distance
over the spread) and `map_spread` are reported beside it.

variant "control" puts the next precision below the configuration's in the
program's place: for "fused" the program's own int8 path (`fused_int8` of
the same bundle, served in the window); for "fused_int8" the reference's
int4 tower (no window).
"""

from __future__ import annotations

import gc
import shutil
import tempfile
import threading
import time

import numpy as np
import torch

from rgp_bench import compare, weights
from rgp_bench.cell import Context, Outcome
from rgp_bench.profile import TRACE_SECONDS, Trace
from rgp_bench.reference import tower as ref_tower
from rgp_bench.reference import video as ref_video


def _program(cell, seed: int, device, program: str):
    """The served function of a bundle written and read back, from the
    seed's weights."""
    from recurrent_gaze_prediction_tpu_torch import registry
    from recurrent_gaze_prediction_tpu_torch.config import ModelConfig
    from recurrent_gaze_prediction_tpu_torch.models import c3d, quant
    from recurrent_gaze_prediction_tpu_torch.serving import bundle

    cfg, tr = cell.config, cell.traffic
    hw = tuple(cfg["c3d"]["video_hw"])
    model = registry.build_model(ModelConfig(**cfg["model"]), device=device)
    model.load_state_dict(weights.head(cfg, seed, device))
    tower = weights.tower(cfg, seed, device)
    path = tempfile.mkdtemp(prefix="rgp_bench_bundle_")
    try:
        kwargs = dict(num_frames=tr["frames"], video_hw=hw,
                      video_dtype="uint8")
        if program == "fused_int8":
            calib = weights.videos(seed, "calib", (tr["calib_windows"], 16,
                                                   *hw, 3), device)
            kwargs["int8_qparams"] = quant.quantize_for_pipeline(
                tower, calib_clips=c3d.preprocess_frames(calib))
        else:
            kwargs["c3d_params"] = tower
            kwargs["c3d_compute_dtype"] = cfg["tower_precision"]["fused"]
        bundle.save_bundle(path, model, **kwargs)
        served = bundle.load_bundle(path, device=device)
    finally:
        shutil.rmtree(path, ignore_errors=True)
    fn = (bundle.fused_int8_predict_fn if program == "fused_int8"
          else bundle.fused_predict_fn)(served)
    return fn, served


class _Callers:
    """`callers` threads in a closed loop over the pool until a deadline;
    each keeps the sampled rows of each reply."""

    def __init__(self, fn, pool: list, rows: list, callers: int):
        self.fn, self.pool, self.rows = fn, pool, rows
        self.callers = callers
        self.latencies: list = []
        self.failures: list = []
        self.kept: list = []          # (pool index, maps of the rows)
        self.lock = threading.Lock()

    def _loop(self, c: int, deadline: float, count: list) -> None:
        k = c * len(self.pool) // self.callers
        while (count is not None and count[c] > 0) or (
                count is None and time.perf_counter() < deadline):
            i = k % len(self.pool)
            k += 1
            start = time.perf_counter()
            try:
                maps = self.fn(self.pool[i]).cpu().numpy()
            except Exception as exc:  # a failed request is counted
                with self.lock:
                    self.failures.append(repr(exc))
                    self.latencies.append(time.perf_counter() - start)
            else:
                done = time.perf_counter()
                with self.lock:
                    self.latencies.append(done - start)
                    self.kept.append((i, maps[self.rows[i]]))
            if count is not None:
                count[c] -= 1

    def run(self, seconds: float = 0.0, requests_each: int = 0) -> float:
        """Until `seconds` have passed (each caller finishes the request it
        is in), or `requests_each` requests per caller; -> the seconds from
        the start until the device has finished."""
        count = [requests_each] * self.callers if requests_each else None
        start = time.perf_counter()
        threads = [threading.Thread(target=self._loop,
                                    args=(c, start + seconds, count))
                   for c in range(self.callers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return time.perf_counter() - start

    def reset(self) -> None:
        self.latencies, self.failures, self.kept = [], [], []


def _pool(cell, seed: int, device) -> tuple:
    cfg, tr = cell.config, cell.traffic
    shape = (tr["batch"], tr["frames"], *cfg["c3d"]["video_hw"], 3)
    pool = [weights.videos(seed, f"pool{i}", shape, device).cpu().numpy()
            for i in range(tr["pool_batches"])]
    pick = torch.Generator().manual_seed(weights.sub_seed(seed, "rows"))
    rows = [np.sort(torch.randperm(tr["batch"], generator=pick)[
        :tr["reference_rows"]].numpy()) for _ in pool]
    return pool, rows


def _reference_maps(cell, seed: int, device, pool: list, rows: list,
                    qmax) -> list:
    """The reference's maps of the sampled rows of each pool batch; qmax
    None: the float32 tower, else the quantized tower at qmax."""
    cfg = cell.config
    crop, mean = cfg["c3d"]["crop"], cfg["c3d"]["mean_pixel"]
    tw = weights.tower(cfg, seed, device)
    hw = tuple(cfg["c3d"]["video_hw"])
    if qmax is None:
        def tower_fn(clips):
            return ref_tower.tower_f32(tw, clips)
    else:
        calib = weights.videos(seed, "calib", (cell.traffic["calib_windows"],
                                               16, *hw, 3), device)
        scales = ref_tower.calibrate(tw, ref_tower.preprocess(
            calib, crop, mean), qmax)

        def tower_fn(clips):
            return ref_tower.tower_int(tw, scales, clips, qmax)
    head = weights.head(cfg, seed, device)
    out = []
    with torch.inference_mode():
        for video, r in zip(pool, rows):
            v = torch.from_numpy(video[r]).to(device)
            out.append(ref_video.gaze_maps(tower_fn, head, cfg["cell"], v,
                                           crop, mean).float().cpu())
    return out


def _upload_rate(video: np.ndarray, device) -> float:
    """GB/s of a pageable copy of one request to the device, after the
    window: the host's copy rate in this run, beside its numbers."""
    start = time.perf_counter()
    for _ in range(3):
        torch.as_tensor(video).to(device)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return 3 * video.nbytes / (time.perf_counter() - start) / 1e9


def _free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _serve(cell, seed: int, device, pool: list, rows: list, program: str,
           seconds: float, trace: bool, notes: dict) -> dict:
    """Set the program up, warm it, run the window (and the traced
    window), free it -> what the callers kept and timed."""
    t0 = time.perf_counter()
    fn, served = _program(cell, seed, device, program)
    t1 = time.perf_counter()
    callers = _Callers(fn, pool, rows, cell.traffic["callers"])
    callers.run(requests_each=cell.traffic["warmup_requests"])
    notes.update(setup_bundle_s=t1 - t0,
                 setup_warmup_s=time.perf_counter() - t1)
    if callers.failures:
        raise RuntimeError(f"warm-up failed: {callers.failures[0]}")
    callers.reset()
    out = {"window_start": time.perf_counter(), "trace": None,
           "trace_units": 0}
    out["window_s"] = callers.run(seconds=seconds)
    out["latencies"] = list(callers.latencies)
    out["failed"] = len(callers.failures)
    if trace:
        profile = Trace()
        profile.start()
        callers.run(seconds=min(seconds, TRACE_SECONDS))
        out["trace"] = profile.stop()
        out["trace_units"] = len(callers.latencies) - len(out["latencies"])
    out["peak"] = (torch.cuda.max_memory_allocated(device)
                   if torch.device(device).type == "cuda" else 0)
    notes["upload_gb_per_s"] = _upload_rate(pool[0], device)
    out["kept"], out["attempted"] = callers.kept, len(callers.latencies)
    out["failed_all"] = len(callers.failures)
    del fn, served, callers
    _free()
    return out


def run(cell, seed: int, seconds: float, trace: bool, device,
        variant: str = "program") -> Outcome:
    cfg, tr = cell.config, cell.traffic
    program = tr["program"]
    t0 = time.perf_counter()
    pool, rows = _pool(cell, seed, device)
    notes: dict = {"setup_pool_s": time.perf_counter() - t0}
    served = "fused_int8" if variant == "control" else program
    if variant == "control" and program == "fused_int8":
        # the reference's int4 tower in the program's place: one reply per
        # pool batch, no window
        replies = _reference_maps(cell, seed, device, pool, rows, 7.0)
        run_ = {"window_start": time.perf_counter(), "window_s": 0.0,
                "latencies": [], "failed": 0, "failed_all": 0,
                "trace": None, "trace_units": 0, "peak": 0,
                "kept": [(i, m.numpy()) for i, m in enumerate(replies)],
                "attempted": len(replies)}
    else:
        run_ = _serve(cell, seed, device, pool, rows, served, seconds,
                      trace, notes)
    reference = _reference_maps(cell, seed, device, pool, rows,
                                127.0 if program == "fused_int8" else None)
    gaps = torch.cat([compare.map_l1(torch.from_numpy(m), reference[i])
                      .flatten() for i, m in run_["kept"]] or
                     [torch.full((1,), float("nan"))])
    spread = compare.map_spread(reference)
    latencies, e2e = run_["latencies"], {}
    if latencies:
        e2e = {"video_frames_per_s": (len(latencies) - run_["failed"])
               * tr["batch"] * tr["frames"] / run_["window_s"],
               "video_request_p95_ms": float(np.percentile(
                   latencies, 95)) * 1e3}
        half = max(len(latencies) // 2, 1)
        notes["latency_ms"] = {
            "median": float(np.median(latencies)) * 1e3,
            "p95_first_half": float(np.percentile(
                latencies[:half], 95)) * 1e3,
            "p95_second_half": float(np.percentile(
                latencies[-half:], 95)) * 1e3}
    shapes = {"batch": tr["batch"], "frames": tr["frames"],
              "timesteps": ref_video.timesteps(tr["frames"]),
              "program": served, "cell": cfg["cell"], "model": cfg["model"],
              "c3d_channels": cfg["c3d"]["channels"],
              "crop": cfg["c3d"]["crop"]}
    context = Context(cell=cell, window_s=run_["window_s"],
                      units=len(latencies), shapes=shapes, spans={},
                      trace=run_["trace"], trace_units=run_["trace_units"])
    return Outcome(attempted=run_["attempted"], failed=run_["failed_all"],
                   end_to_end=e2e,
                   readings={"map_gap": float(gaps.max()) / spread,
                             "map_gap_mean": float(gaps.mean()) / spread,
                             "map_spread": spread},
                   memory_peak_bytes=int(run_["peak"]),
                   window_start=run_["window_start"], context=context,
                   notes=notes)
