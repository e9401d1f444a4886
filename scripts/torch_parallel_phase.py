#!/usr/bin/env python3
"""The multi-rank phase of chip_smoke.py (phase 17) alone, on one CUDA card.

    python3 scripts/torch_parallel_phase.py     # from the repo root

Builds the kernels, then runs two ranks on cuda:0 over gloo against one
process (3 sharded train steps at a global B=28, sharded predict of
gaze_grcn and gaze_lstm, the temporal fused predict of one F=160 video,
the sharded evaluate of 8192 frames) and `cli.train_gaze --data_parallel
-1` under torchrun at world 1 (NCCL) against the run without the flag,
with chip_smoke.py's gates; prints the sharded step's and the gradient
all-reduce's times beside the one-process step's, and a JSON summary.
Exits 1 on the first gate that fails.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    cs.check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    card = cs.card_line()
    print(card, flush=True)
    start = time.perf_counter()
    cs.build.load()
    print(f"build: {time.perf_counter() - start:.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as runs:
        start = time.perf_counter()
        par = cs.parallel_phase(card, runs)
        seconds = time.perf_counter() - start
    print(f"timing: sharded train step, 2 ranks sharing one card over gloo, "
          f"global B={cs.TRAIN_BATCH}: {par['step_ms']} ms per step (rank 0, "
          f"1); one process: {par['one_ms']:.3f} ms; gradient all-reduce of "
          f"{par['grad_floats']} f32: {par['allreduce_ms']} ms (rank 0, 1); "
          f"two ranks on one card measure the program, not the scaling "
          f"[{card}]", flush=True)
    print(json.dumps({**par, "phase_s": seconds, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
