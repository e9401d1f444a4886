#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # from the repo root; needs one CUDA card

In order, failing (exit 1) on the first check that does not hold:
  1. requires CUDA and prints the card's name and power limit;
  2. builds the CUDA kernels from csrc/ and prints the build time;
  3. holds the ConvGRU kernel against its plain PyTorch version
     (`convgru_parity`, T=42, B=8, 512->128) in bf16 under the JAX
     package's gate, and in f32 with TF32 off;
  4. serves a full-width gaze_grcn (1024->512->128, T=42, 49x49 maps, bf16,
     seeded random weights) over HTTP from a bundle: concurrent single-clip
     POSTs, each reply checked against the plain path's predict of the same
     clip, and the kernel's launch count over that run checked;
  5. times the kernel and its plain version (B=8, B=16), the feature-fed
     predict (B=16) and the HTTP requests, with CUDA events or the host
     clock after warm-up;
  6. prints the kernels' JSON line, then, last, the device JSON line.
"""

from __future__ import annotations

import io
import json
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

from recurrent_gaze_prediction_tpu_torch import registry
from recurrent_gaze_prediction_tpu_torch.models.common import (
    apply_c3d_projection, apply_decoder)
from recurrent_gaze_prediction_tpu_torch.ops.cells import ConvGRU
from recurrent_gaze_prediction_tpu_torch.ops.kernels import build
from recurrent_gaze_prediction_tpu_torch.ops.kernels import convgru as kconv
from recurrent_gaze_prediction_tpu_torch.ops.kernels.parity import (
    MIN_CORR, convgru_parity, parity_ok)
from recurrent_gaze_prediction_tpu_torch.ops.normalize import softmax_2d
from recurrent_gaze_prediction_tpu_torch.serving import (
    load_bundle, save_bundle, server_from_bundle)

SEED = 0
T = 42
N_REQUESTS = 8
# f32 mode: the kernel's scalar f32 FMAs against cuDNN's f32 convs with
# TF32 off differ only in summation order (~1e-7 per step), amplified by
# the recurrence over 42 steps; 1e-3 leaves a wide margin above that and
# stays far below what a wrong gate or shift gives.
F32_MAX_REL_DELTA = 1e-3
# Served maps against the plain path: the kernel keeps its conv results in
# f32 where the plain path rounds them to bf16; the JAX package's gate.
MAP_MIN_CORR = 0.999
# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
STATE_STDDEV = 0.05  # the reference init (1e-4) leaves the recurrence ~0


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def corr(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.corrcoef(a.ravel(), b.ravel())[0, 1])


def post(url: str, frames: np.ndarray, c3d: np.ndarray) -> tuple:
    buf = io.BytesIO()
    np.savez(buf, frames=frames, c3d=c3d)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    start = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as resp:
        status, body = resp.status, resp.read()
    seconds = time.perf_counter() - start
    return status, np.load(io.BytesIO(body))["gazemaps"], seconds


def post_all(url: str, frames: np.ndarray, c3d: np.ndarray) -> list:
    """POST clip i from thread i, all at once; (status, maps, s) each."""
    results: list = [None] * len(c3d)
    errors: list = []

    def one(i: int) -> None:
        try:
            results[i] = post(url, frames[i], c3d[i])
        except Exception as e:  # reported below; the run fails
            errors.append(f"request {i}: {e!r}")

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(c3d))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    check(not errors and all(r is not None for r in results),
          f"requests failed: {errors}")
    return results


def kernel_timing(fused: dict, b: int, rng: np.random.RandomState) -> dict:
    """The kernel and its plain version on the same precomputed gates."""
    dev = torch.device("cuda")
    c = fused["Wx_zrc"].shape[2]
    units = fused["U_c"].shape[-1]
    xs = torch.from_numpy(
        rng.randn(T, b, 7, 7, c).astype(np.float32)).to(dev)
    h0 = ConvGRU.zero_state(b, (7, 7), units, device=dev)
    with torch.inference_mode():
        wx = ConvGRU.input_gates(fused, xs, torch.bfloat16)
        ms = cuda_ms(lambda: kconv.convgru_recurrence(fused, wx, h0), 20)
        plain_ms = cuda_ms(lambda: ConvGRU.scan_precomputed(
            fused, wx, h0, torch.bfloat16), 5)
    flops = T * b * 49 * 9 * units * 3 * units * 2
    nbytes = (wx.numel() * 2 + T * b * 49 * units * 4          # wx, ys
              + (fused["Uh_zr"].numel() + fused["U_c"].numel()) * 2
              + 2 * b * 49 * units * 4)                        # h0, hT
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return {"ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "gflop": flops / 1e9, "mbytes": nbytes / 1e6}


def predict_breakdown(model, c3d: torch.Tensor) -> dict:
    """CUDA-event times of the stages of gaze_grcn's predict, each run
    alone on the outputs of the stage before (bf16 compute)."""
    cdt = torch.bfloat16
    b, t = c3d.shape[:2]
    units = model.cfg.rnn_state_size
    stage = dict(keep_prob=1.0, generator=None, train=False,
                 compute_dtype=cdt)
    with torch.inference_mode():
        fused = ConvGRU.fuse(model.cell)
        h0 = ConvGRU.zero_state(b, (7, 7), units, device=c3d.device)
        fns = {"projection": lambda: apply_c3d_projection(
            model.c3d_proj, c3d, **stage)}
        xs = fns["projection"]().transpose(0, 1)
        fns["input_gates"] = lambda: ConvGRU.input_gates(fused, xs, cdt)
        wx = fns["input_gates"]()
        fns["recurrence_kernel"] = lambda: kconv.convgru_recurrence(
            fused, wx, h0)
        folded = fns["recurrence_kernel"]()[1].transpose(0, 1).reshape(
            b * t, 7, 7, units)
        fns["decoder_softmax"] = lambda: softmax_2d(apply_decoder(
            model.decoder, folded, **stage))
        return {name: cuda_ms(fn, 10) for name, fn in fns.items()}


def main() -> int:
    # 1. the card
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    card = card_line()
    print(card, flush=True)  # name, power limit: as nvidia-smi prints them

    # 2. build
    start = time.perf_counter()
    build.load()
    print(f"build: {time.perf_counter() - start:.1f} s "
          f"({build.last_build['path']})", flush=True)
    for line in build.last_build["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # 3. kernel against plain version
    bf16 = convgru_parity(t=T, b=8, device="cuda")
    print(f"parity bf16: {json.dumps(bf16)}", flush=True)
    check(parity_ok(bf16), f"bf16 parity gate failed: {bf16}")
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        f32 = convgru_parity(t=T, b=8, compute_dtype=torch.float32,
                             device="cuda")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    print(f"parity f32 (TF32 off): {json.dumps(f32)}", flush=True)
    check(parity_ok(f32, max_rel_delta=F32_MAX_REL_DELTA),
          f"f32 parity failed (corr >= {MIN_CORR}, max_rel_delta <= "
          f"{F32_MAX_REL_DELTA}, final h == ys[-1]): {f32}")

    # 4. serving at full width through the kernel
    gen = torch.Generator().manual_seed(SEED)
    model = registry.create_model(
        "gaze_grcn", dim_feature=1024, dim_cnn_proj=512, rnn_state_size=128,
        n_lstm_steps=T, gazemap_height=49, gazemap_width=49,
        compute_dtype="bfloat16", device="cuda", generator=gen)
    with torch.no_grad():
        for p in model.cell.values():
            p.copy_(torch.randn(p.shape, generator=gen) * STATE_STDDEV)
    rng = np.random.RandomState(SEED)
    c3d = rng.randn(N_REQUESTS, T, 1024, 7, 7).astype(np.float32)
    frames = rng.rand(N_REQUESTS, T, 98, 98, 3).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        save_bundle(f"{tmp}/bundle", model)
        server = server_from_bundle(f"{tmp}/bundle", device="cuda",
                                    max_batch=32, max_wait_ms=50.0).start()
        try:
            host, port = server.address
            url = f"http://{host}:{port}"
            kconv.launches = 0
            served = post_all(f"{url}/predict", frames, c3d)
            torch.cuda.synchronize()
            main_launches = kconv.launches
            with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
                health = json.loads(r.read())
            print(f"serving: {N_REQUESTS} concurrent requests, healthz "
                  f"{health}, kernel launches {main_launches}", flush=True)
            check(main_launches >= 1, "the served path never launched the "
                                      "ConvGRU kernel")
            check(health["requests"] == N_REQUESTS
                  and main_launches == health["calls"],
                  f"healthz {health} does not count the {N_REQUESTS} "
                  f"requests / {main_launches} kernel launches")

            reference = load_bundle(f"{tmp}/bundle", device="cuda")
            reference.cfg.dropout_keep_prob = 1.0  # train path = plain scan
            with torch.no_grad():
                plain = softmax_2d(reference(
                    None, torch.from_numpy(c3d).cuda(), train=True))
            plain = plain.cpu().numpy()
            for i, (status, maps, _) in enumerate(served):
                check(status == 200, f"request {i}: HTTP {status}")
                check(maps.shape == (T, 49, 49),
                      f"request {i}: gazemaps shape {maps.shape}")
                check(bool(np.isfinite(maps).all()),
                      f"request {i}: non-finite maps")
                sums = maps.reshape(T, -1).sum(-1)
                check(bool(np.abs(sums - 1.0).max() <= 1e-3),
                      f"request {i}: map sums off 1 by "
                      f"{np.abs(sums - 1.0).max()}")
                c = corr(maps, plain[i])
                check(c >= MAP_MIN_CORR,
                      f"request {i}: corr {c} vs the plain path")
            print(f"serving: all {N_REQUESTS} replies HTTP 200, "
                  f"[{T},49,49] finite, sums 1 within 1e-3, min corr vs "
                  f"plain path {min(corr(m, plain[i]) for i, (_, m, _) in enumerate(served)):.6f}",
                  flush=True)

            # 5. timings
            again = post_all(f"{url}/predict", frames, c3d)
            http_ms = statistics.median(s for _, _, s in again) * 1e3
        finally:
            server.close()

    fused = ConvGRU.fuse({k: v.detach() for k, v in model.cell.items()})
    timing_rng = np.random.RandomState(SEED + 1)
    k8 = kernel_timing(fused, 8, timing_rng)
    k16 = kernel_timing(fused, 16, timing_rng)
    for b, k in ((8, k8), (16, k16)):
        print(f"timing: convgru kernel T={T} B={b} U=128 bf16: "
              f"{k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, bound "
              f"{k['bound_ms']:.4f} ms ({k['bound_by']}: {k['gflop']:.2f} "
              f"GFLOP, {k['mbytes']:.1f} MB) [{card}]", flush=True)
    c3d16 = torch.from_numpy(
        timing_rng.randn(16, T, 1024, 7, 7).astype(np.float32)).cuda()
    predict_ms = cuda_ms(lambda: model.predict(None, c3d16), 10)
    print(f"timing: feature-fed predict B=16 T={T}: {predict_ms:.3f} ms/call "
          f"[{card}]")
    stages = predict_breakdown(model, c3d16)
    print("timing: predict B=16 stages (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items()) + f" [{card}]")
    print(f"timing: HTTP request latency, median of {N_REQUESTS} concurrent "
          f"single-clip POSTs: {http_ms:.1f} ms [{card}]")

    # 6. result lines
    print(json.dumps({"kernels": [{
        "name": "convgru_fwd",
        "route": "cuda",
        "source": "recurrent_gaze_prediction_tpu_torch/csrc/convgru_fwd.cu",
        "replaces": "recurrent_gaze_prediction_tpu/ops/pallas/convgru.py:45",
        "launches": main_launches,
        "max_abs_err": bf16["max_delta"],
        "ms": k8["ms"],
        "plain_ms": k8["plain_ms"],
        "bound_ms": k8["bound_ms"],
        "bound_by": k8["bound_by"],
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
