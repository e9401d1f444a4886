"""The benchmark of `recurrent_gaze_prediction_tpu_torch`, the PyTorch and
CUDA program, on one NVIDIA H100.

One command runs one cell (a configuration under a traffic mix) once:

    python3 -m rgp_bench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

`BENCHMARK.json` at the repository's root names the cells and metrics.
Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by its name:

    rgp_bench/configs/<config>.json     sizes and precisions of a model
    rgp_bench/traffic/<traffic>.json    a traffic mix; its "generator"
                                        names the code that runs it
    rgp_bench/generators/<name>.py      a traffic generator (video
                                        serving, training)
    rgp_bench/limits/<workload>.json    a cell's limits on `correct`
    rgp_bench/metrics/<metric>.py       a per-layer metric's reader

The yardstick lives here too: the seeded weights and traffic
(`weights.py`, the generators), the trace's reduction (`profile.py`), the
peaks and the counts of operations and bytes (`counts/`), the plain
reference (`reference/`, which imports nothing of the program) and the
comparison that decides `correct` (`compare.py`).
"""
