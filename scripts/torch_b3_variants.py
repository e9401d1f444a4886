#!/usr/bin/env python3
"""Time variants of the PyTorch port's kernel B3 (`csrc/convlstm_fwd.cu`,
the peephole ConvLSTM forward) against the kernel as committed, on one
NVIDIA card.

    python3 scripts/torch_b3_variants.py     # from the repo root

A variant is the committed source with a few lines replaced. Each
replacement must match exactly once, so an edited source fails here
instead of timing something else. The variant is built with the other
kernels into its own library under the package's `_build/`, then run
through the normal wrapper with that library swapped in. The committed
kernel keeps two copies of the padded operand hpad (ping-pong): step t's
conv reads copy t % 2 and its h' goes into the other, so one cluster
barrier per step suffices. The variants:
  * `one_hpad`: one copy, so a second cluster barrier per step separates
    every CTA's conv from its peers' stores of h';
  * `one_hpad_two_kgroups`: that, with the conv's depth split over two
    warp groups (two planes of partial sums), so at U=128 all 16 warps
    hold a conv item with half the k-steps. Ping-pong with two k-groups
    does not fit shared memory.
Each variant must pass the kernel's gate against its plain version (bf16
and f32, B=8, nonzero carries, the final c), then all are timed at T=42,
U=128, bf16, B=1, 8 and 16 with CUDA events, in turns: committed,
variants, variants reversed, committed. The last line is a JSON object of
the times.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (F32_MAX_REL_DELTA, T, UNITS, card_line,  # noqa: E402
                        cuda_ms, tf32_off)
from recurrent_gaze_prediction_tpu_torch.ops.kernels import build  # noqa: E402
from recurrent_gaze_prediction_tpu_torch.ops.kernels import (  # noqa: E402
    convlstm as klstm)
from recurrent_gaze_prediction_tpu_torch.ops.kernels.parity import (  # noqa: E402
    convlstm_parity, parity_ok)

SOURCE = "convlstm_fwd.cu"
ONE_HPAD = [
    ("  o += 2 * pad_bytes(g, U, elem);", "  o += pad_bytes(g, U, elem);"),
    ("  zero_fill(hpad, 2 * hpad_n * sizeof(T));",
     "  zero_fill(hpad, hpad_n * sizeof(T));"),
    ("conv_slice<kLstmKGroups>(hpad + (t & 1) * hpad_n, U, w, N, g, acc);",
     "conv_slice<kLstmKGroups>(hpad, U, w, N, g, acc);"),
    ("    __syncthreads();     // acc is complete\n",
     "    __syncthreads();     // acc is complete\n"
     "    cluster.sync();  // every CTA has read its hpad\n"),
    ("    T* next = hpad + ((t + 1) & 1) * hpad_n;", "    T* next = hpad;"),
]
VARIANTS = {
    "one_hpad": ONE_HPAD,
    "one_hpad_two_kgroups": ONE_HPAD + [
        ("constexpr int kLstmKGroups = 1;", "constexpr int kLstmKGroups = 2;")],
}
BATCHES = (1, 8, 16)


def variant_source(replacements: list) -> str:
    text = (build.CSRC_DIR / SOURCE).read_text()
    for old, new in replacements:
        if text.count(old) != 1:
            raise RuntimeError(f"{old!r} appears {text.count(old)} times in "
                               f"{SOURCE}, not once")
        text = text.replace(old, new)
    return text


def build_variants() -> dict:
    """{name: library} for the committed kernels and each variant."""
    libs = {"committed": build.load()}
    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    others = [s for s in build._sources() if s.name != SOURCE]
    compile_ = [nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR), "-c"]
    objects = [out / f"{s.stem}.o" for s in others]
    sources = []
    for name, replacements in VARIANTS.items():
        src = out / f"convlstm_fwd_{name}.cu"
        src.write_text(variant_source(replacements))
        sources.append(src)
    objects += [out / f"{s.stem}.o" for s in sources]
    build._run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True))
                for cmd in ([*compile_, "-o", str(o), str(s)]
                            for s, o in zip(others + sources, objects))])
    for name, src in zip(VARIANTS, sources):
        lib = out / f"librgp_kernels-{name}.so"
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                "-o", str(lib), *map(str, objects[:len(others)]),
                str(out / f"{src.stem}.o")]
        build._run([(link, subprocess.Popen(link, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))])
        libs[name] = build._declare(ctypes.CDLL(str(lib)))
    return libs


def run_with(lib, fn):
    """fn() with `lib` as the kernels' library."""
    saved, build._lib = build._lib, lib
    try:
        return fn()
    finally:
        build._lib = saved


def lstm_inputs(b: int, rng: np.random.RandomState) -> tuple:
    """Full-width B3 inputs: weights N(0, 0.1), gx N(0, 1) in bf16, the
    carries N(0, 0.5)."""
    dev = torch.device("cuda")
    fused = {"Wh": rng.randn(3, 3, UNITS, 4 * UNITS) * 0.1,
             **{k: rng.randn(7, 7, UNITS) * 0.1
                for k in ("W_ci", "W_cf", "W_co")}}
    fused = {k: torch.from_numpy(v.astype(np.float32)).to(dev)
             for k, v in fused.items()}
    gx = torch.from_numpy(rng.randn(T, b, 7, 7, 4 * UNITS).astype(
        np.float32)).to(dev, torch.bfloat16)
    carry = tuple(torch.from_numpy((rng.randn(b, 7, 7, UNITS) * 0.5).astype(
        np.float32)).to(dev) for _ in range(2))
    return fused, gx, carry


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    libs = build_variants()
    for name, lib in libs.items():
        smem = lib.convlstm_fwd_smem_bytes(7, 7, UNITS, 2)
        fit = lib.convlstm_fwd_max_clusters(7, 7, UNITS, 2)
        bf16 = run_with(lib, lambda: convlstm_parity(t=T, b=8,
                                                     device="cuda"))
        with tf32_off():
            f32 = run_with(lib, lambda: convlstm_parity(
                t=T, b=8, compute_dtype=torch.float32, device="cuda"))
        ok = parity_ok(bf16) and parity_ok(f32, F32_MAX_REL_DELTA)
        print(f"{name}: smem per CTA {smem} B, {fit} clusters fit; bf16 "
              f"max_rel_delta {bf16['max_rel_delta']:.4g} (final c "
              f"{bf16['final_c']['max_rel_delta']:.4g}), f32 "
              f"{f32['max_rel_delta']:.4g}; gate {'ok' if ok else 'FAILED'}",
              flush=True)
        if not ok or fit < 1:
            return 1
    order = list(libs) + list(libs)[::-1]
    times: dict = {name: {b: [] for b in BATCHES} for name in libs}
    rng = np.random.RandomState(0)
    for b in BATCHES:
        fused, gx, carry = lstm_inputs(b, rng)
        with torch.inference_mode():
            for name in order:
                times[name][b].append(run_with(libs[name], lambda: cuda_ms(
                    lambda: klstm.convlstm_recurrence(fused, gx, *carry),
                    20)))
        print(f"B={b}: " + "; ".join(
            f"{name} {', '.join(f'{ms:.4f}' for ms in times[name][b])} ms "
            f"({np.mean(times[name][b]) * 1e3 / T:.2f} us/step)"
            for name in libs) + f" [{card}]", flush=True)
    print(json.dumps({"card": card, "T": T, "units": UNITS, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
