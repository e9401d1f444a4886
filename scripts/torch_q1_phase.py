#!/usr/bin/env python3
"""Kernel Q1's phase of chip_smoke.py alone, on one CUDA card.

    python3 scripts/torch_q1_phase.py     # from the repo root

Builds the kernels, trains the gaze_grcn CLI run that the `fused_int8`
export needs (chip_smoke's phase 5, 20 steps), then runs phase 15 (Q1 and
Q1-pool bitwise against their plain versions per layer, the int8 tower at
160 clips against the plain int8 tower and the bf16 tower, `fused_int8`
exported and served over HTTP) and the int8 timings (each layer beside its
bound, plain version, `torch._int_mm` and cuDNN bf16; the towers in turns;
`fused_int8` against `fused` predict at B=8 and 16). Exits 1 on the first
gate that fails, as chip_smoke.py does.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    cs.check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    card = cs.card_line()
    print(card, flush=True)
    start = time.perf_counter()
    cs.build.load()
    print(f"build: {time.perf_counter() - start:.1f} s", flush=True)
    for line in cs.build.last_build["log"].splitlines():
        if "conv3d_int8" in line or "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    videos = np.random.RandomState(cs.SEED + 16).randint(
        0, 256, (cs.N_REQUESTS, cs.FUSED_FRAMES, *cs.VIDEO_HW, 3)).astype(
            np.uint8)
    with tempfile.TemporaryDirectory() as runs:
        cs.train_through_cli(card, f"{runs}/grcn")
        int8 = cs.int8_phases(card, runs, videos)
        timed = cs.int8_timings(card, int8["qparams"], int8["tower"],
                                int8["clips"])
        fused = {b: cs.fused_int8_timing(int8["served"]["model"], b)
                 for b in cs.FUSED_BATCHES}
    for b, ft in fused.items():
        print(f"timing: gaze_grcn fused_int8 predict B={b} "
              f"F={cs.FUSED_FRAMES}, in turns with its fused program: "
              f"fused_int8 {ft['fused_int8']:.3f} ms/call, fused "
              f"{ft['fused']:.3f} ms/call [{card}]", flush=True)
    layers = timed["layers"]
    print(json.dumps({
        "q1_ms": sum(r["ms"] for r in layers.values()),
        "int_mm_ms": sum(r["int_mm_ms"] for r in layers.values()),
        "cudnn_bf16_ms": sum(r["cudnn_bf16_ms"] for r in layers.values()),
        "bound_ms": sum(r["bound_ms"] for r in layers.values()),
        "pools_ms": sum(r["ms"] for r in timed["pools"].values()),
        "tower": {k: v for k, v in timed["tower"].items() if k != "runs"},
        "fused_int8": fused, "http_ms": int8["served"]["http_ms"],
        "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
