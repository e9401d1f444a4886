#!/usr/bin/env python3
"""B4's phases G and W, and V2's backward through them, alone on one CUDA
card: the parts of chip_smoke.py that time and gate them.

    python3 scripts/torch_gw_phase.py     # from the repo root

Builds the kernels (printing ptxas's registers and spills for G and W),
gates G and W against their plain versions (bf16 and f32 with TF32 off)
at T=42, U=128, B=8 / 16 / 28 and at gaze_pupil_grcn's U=64, T=35, B=7,
then times each beside its bound, plain version and library call (cuDNN
`conv2d` / `conv2d_weight`), B4's device time by kernel at B=28, V2's
backward through its library stages and through G + B2 + W in turns, and
the B=28 train step through both routes and plain autograd. Exits 1 on
the first gate that fails, as chip_smoke.py does.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

KERNELS = ("convgru_bwd_gates", "convgru_wgrad")


def gate(kernel: str, b: int, **shape) -> None:
    stats = cs.backward_parity(kernel, b=b, device="cuda", **shape)
    with cs.tf32_off():
        stats32 = cs.backward_parity(kernel, b=b, compute_dtype=torch.float32,
                                     device="cuda", **shape)
    print(f"parity {kernel} B={b} {shape}: bf16 "
          f"{json.dumps(stats['outputs'])}; f32 "
          f"{json.dumps(stats32['outputs'])}", flush=True)
    cs.check(cs.backward_parity_ok(stats), f"{kernel} bf16 gate at B={b}")
    cs.check(cs.backward_parity_ok(stats32,
                                   max_rel_delta=cs.F32_MAX_REL_DELTA),
             f"{kernel} f32 parity at B={b}")


def main() -> int:
    cs.check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    card = cs.card_line()
    print(card, flush=True)
    start = time.perf_counter()
    cs.build.load()
    print(f"build: {time.perf_counter() - start:.1f} s", flush=True)
    lines = cs.build.last_build["log"].splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and ("gates" in line or "wgrad" in line):
            print("  ptxas: " + " | ".join(x.strip() for x in lines[i:i + 4]
                                           if "Compiling" not in x))
    pupil = dict(t=cs.C4_T, c=cs.C4_C, units=cs.C4_UNITS)
    for kernel in KERNELS:
        for b in cs.GW_BATCHES:
            gate(kernel, b, t=cs.T)
        gate(kernel, cs.C4_BATCHES[0], **pupil)
    for kernel in KERNELS:
        for b, shape in [(b, {}) for b in cs.GW_BATCHES] + [
                (cs.C4_BATCHES[0], pupil)]:
            k = cs.backward_timing(kernel, b, cs.SEED + b, **shape)
            print(f"timing: {kernel} B={b} {shape or 'U=128 T=42'} bf16: "
                  f"{cs.per_step(k, shape.get('t', cs.T))}, library_ms "
                  f"{k['library_ms']:.4f} ms [{card}]", flush=True)
    for b in cs.GW_BATCHES:
        parts = cs.b4_breakdown(b)
        print(f"timing: convgru_bwd_mono B={b} device time per call by "
              f"kernel (torch.profiler, ms): " + ", ".join(
                  f"{k} {v:.4f}" for k, v in parts.items()) + f" [{card}]",
              flush=True)
    route = cs.v2_route_timing(cs.TRAIN_BATCH)
    print(f"timing: V2 backward B={cs.TRAIN_BATCH} in turns (ms): library "
          f"stages {route['library_ms']:.4f}, G + B2 + W "
          f"{route['kernels_ms']:.4f}; runs {json.dumps(route['runs'])} "
          f"[{card}]", flush=True)
    raw_batch = cs.synthetic.make_clip_windows(
        cs.TRAIN_BATCH, cs.T, seed=cs.SEED + 3).next_batch(cs.TRAIN_BATCH)
    step = cs.train_step_timing(cs.full_width_model(), raw_batch)
    print(f"timing: train step B={cs.TRAIN_BATCH}: kernels "
          f"{step['kernels_ms']:.3f} ms, V2 library stages "
          f"{step['library_stages_ms']:.3f} ms, plain autograd "
          f"{step['plain_ms']:.3f} ms; runs {json.dumps(step['runs'])}; "
          f"stages (ms) " + ", ".join(f"{k.strip()} {v:.3f}" for k, v in
                                      step["stages"].items())
          + f" [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
