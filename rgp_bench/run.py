"""Run one cell of the benchmark once and print its result line.

    python3 -m rgp_bench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), when the program cannot be imported, and when the
process holds JAX or the JAX package once the window has closed. The last
line of standard output is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer ones), `device`, with `--trace 1` `breakdown`, and last `checks`,
each number compared beside its limit; those also end standard error.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

FORBIDDEN = ("jax", "jaxlib", "flax", "recurrent_gaze_prediction_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def card() -> dict:
    """The card's name and power limit (nvidia-smi)."""
    import torch

    info = {"name": torch.cuda.get_device_name(0)}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        info["power_limit"] = out[0].split(",")[-1].strip() if out else None
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = None
    return info


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device, variant: str = "program") -> dict:
    """One run of `workload` on `device` -> the result line's object."""
    import torch

    from rgp_bench import cell as cells
    from rgp_bench import compare

    cell = cells.load_cell(root, workload)
    outcome = cells.generator(cell).run(cell, seed, seconds, trace, device,
                                     variant=variant)
    correct, checks = compare.judge(outcome.readings, cell.limits)
    correct = correct and outcome.failed == 0
    units = {m["name"]: m["unit"] for m in cell.spec["end_to_end"]
             + cell.spec["per_layer"]}
    metrics = {}
    if trace:
        for m in cell.per_layer():
            value = cells.reader(cell, m["name"]).read(outcome.context)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = dict(outcome.end_to_end,
                   setup_s=outcome.window_start - PROCESS_START)
        for m in cell.end_to_end():
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": units[m["name"]]}
            elif variant == "program":
                raise RuntimeError(f"{workload} did not measure "
                                   f"{m['name']}")
    dev = torch.device(device)
    result = {"correct": bool(correct), "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else
                         dev.type,
                         "kind": (torch.cuda.get_device_name(dev)
                                  if dev.type == "cuda" else "cpu"),
                         "count": 1,
                         "memory_peak_bytes": outcome.memory_peak_bytes}}
    summary = outcome.context.trace
    if trace and summary is not None:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = summary["breakdown"]
        if dev.type == "cuda":
            result["card"] = card()
    result["notes"] = {"threads": torch.get_num_threads(), **outcome.notes}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    # caches of compilers the program might use, at fixed paths in the
    # checkout (the program's kernels build into its own `_build/` there)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(ROOT / ".rgp_bench_cache" / sub)

    import torch

    from rgp_bench.cell import load_cell

    chips = load_cell(ROOT, args.workload).workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"rgp_bench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0))
    loaded = forbidden_modules()
    if loaded:
        print(f"rgp_bench: the run loaded {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']} limit {check['limit']}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
