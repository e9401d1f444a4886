#!/usr/bin/env python3
"""Phase 17 of chip_smoke.py on several cards of one host, over NCCL.

    python3 scripts/torch_multicard.py      # from the repo root; >= 4 cards

Builds the kernels, then runs the multi-rank phase on a 4x1 mesh and on a
2x2 data x model mesh, one rank per card (NCCL), each against one
process on the same inputs with chip_smoke.py's gates (3 sharded SGD
train steps of full-width gaze_grcn at a global B=28, sharded predict of
gaze_grcn and gaze_lstm at B=16, the temporal fused predict where the 10
windows split over the data ranks, the sharded evaluate of 8192 frames);
then `cli.train_gaze --data_parallel -1` under `torch.distributed.run
--nproc_per_node 4` (NCCL, 10 steps at B=28). Prints each mesh's step and
all-reduce times beside the one-process step, and a JSON summary. Exits 1
on the first gate that fails.
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
from recurrent_gaze_prediction_tpu_torch.utils import (  # noqa: E402
    run_processes)

CLI_STEPS = 10


def main() -> int:
    cs.check(torch.cuda.device_count() >= 4,
             f"needs 4 cards, have {torch.cuda.device_count()}")
    card = cs.card_line()
    print(card, flush=True)
    start = time.perf_counter()
    cs.build.load()
    print(f"build: {time.perf_counter() - start:.1f} s", flush=True)
    cards = tuple(f"cuda:{i}" for i in range(4))
    out = {}
    with tempfile.TemporaryDirectory() as runs:
        for data, model in ((4, 1), (2, 2)):
            par = cs.parallel_phase(card, runs, data, model, cards, cli=False)
            print(f"timing: sharded train step, {data}x{model} mesh on 4 "
                  f"cards over NCCL, global B={cs.TRAIN_BATCH}: "
                  f"{[round(x, 3) for x in par['step_ms']]} ms per step by "
                  f"rank; one process on one card: {par['one_ms']:.3f} ms; "
                  f"gradient all-reduce of {par['grad_floats']} f32: "
                  f"{[round(x, 3) for x in par['allreduce_ms']]} ms by rank "
                  f"[{card}]", flush=True)
            out[f"{data}x{model}"] = par
        argv = ["--dataset", "synthetic", "--batch_size",
                str(cs.TRAIN_BATCH), "--synthetic_clips", str(cs.TRAIN_BATCH),
                "--n_lstm_steps", str(cs.T), "--compute_dtype", "bfloat16",
                "--max_steps", str(CLI_STEPS), "--steps_per_logprint", "1",
                "--seed", str(cs.SEED), "--train_dir", f"{runs}/cli4",
                "--data_parallel", "-1"]
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                            "MASTER_ADDR", "MASTER_PORT")}
        start = time.perf_counter()
        (rc, log), = run_processes(
            [[sys.executable, "-m", "torch.distributed.run", "--standalone",
              "--nproc_per_node", "4", "-m",
              "recurrent_gaze_prediction_tpu_torch.cli.train_gaze", *argv]],
            [env], timeout=400)
        seconds = time.perf_counter() - start
        cs.check(rc == 0, f"torchrun x4 cli.train_gaze returned {rc}:\n"
                          f"{log[-4000:]}")
        losses, steps = cs.train_records(f"{runs}/cli4")
        mesh = [line for line in log.splitlines() if "mesh:" in line]
        cs.check(steps == list(range(1, CLI_STEPS + 1))
                 and all(x == x for x in losses) and bool(mesh)
                 and "nccl" in mesh[-1],
                 f"torchrun x4: steps {steps}, losses {losses}, {mesh}")
        with open(f"{runs}/cli4/metrics.jsonl") as f:
            times = [json.loads(line)["time"] for line in f
                     if "loss/train" in line]
        sec = (times[-1] - times[4]) / (len(times) - 5)
        print(f"multicard: torchrun --nproc_per_node 4 cli.train_gaze "
              f"--data_parallel -1 ({seconds:.1f} s wall): "
              f"{mesh[-1].split('INFOV')[-1].strip()}; losses "
              f"{[round(x, 4) for x in losses]}; CLI sec/batch over steps "
              f"6..{CLI_STEPS}: {sec:.4f} (global B={cs.TRAIN_BATCH}) "
              f"[{card}]", flush=True)
        out["cli"] = {"losses": losses, "sec_per_batch": sec}
    print(json.dumps({**out, "card": card, "count":
                      torch.cuda.device_count()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
