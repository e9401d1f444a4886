"""The readings that the limits on `correct` are set from: the numbers a
cell compares, for the sound program and for the controls `correct` has to
refuse, over many seeds in one process (set-up is long; the kernels load
once).

    python3 -m rgp_bench.readings --workload <name> --seeds 1,2,3 \
        --variants program,control [--seconds 3]

Variants: "program" (the timed path, a short window at the cell's load),
"control" (the next precision below the configuration's in the program's
place), and for a training cell the faults "half_batch", "double_grad" and
"unchanged" planted in the reference put in the program's place (see the
traffic generators). One JSON line per run, on standard output.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from rgp_bench import cell as cells
from rgp_bench.run import ROOT


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--variants", default="program,control")
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("rgp_bench.readings: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = cells.load_cell(ROOT, args.workload)
    generator = cells.generator(cell)
    for variant in args.variants.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            start = time.perf_counter()
            out = generator.run(cell, seed, args.seconds, False, device,
                             variant=variant)
            print(json.dumps({
                "workload": args.workload, "variant": variant, "seed": seed,
                "readings": out.readings, "end_to_end": out.end_to_end,
                "attempted": out.attempted, "failed": out.failed,
                "memory_peak_bytes": out.memory_peak_bytes,
                "notes": out.notes,
                "seconds": time.perf_counter() - start}), flush=True)
            del out
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
