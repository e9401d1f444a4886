#!/usr/bin/env python3
"""Time variants of kernel Q1 (`csrc/conv3d_int8.cu`) against the kernel
as committed, layer by layer, on one NVIDIA card.

    python3 scripts/torch_q1_variants.py [VARIANT ...]   # from the repo root

A variant is the committed source with a few lines replaced; each
replacement must match exactly once, so an edited source fails here
instead of timing something else. The variants are built with the other
kernels into their own libraries under the package's `_build/` (one nvcc
per source, all at once), then launched through the wrapper's plan with
their library swapped in. A variant marked `exact` must equal the
committed kernel's output bit for bit; the others take a part of the
kernel away to show what that part costs, and their outputs are not
checked. Each layer (seeded random int8 activations and weights at the
served 160 clips) is timed with CUDA events in turns: committed,
variants, variants reversed, committed. The last line is a JSON object of
the times in ms.

The variants of conv1a's halo route:
  * `no_requant`: the int8 epilogue keeps dequant and relu but replaces
    the requant step by a truncation (what the division costs);
  * `no_epilogue`: the staged bytes are the int32 sums' low bytes (what
    the whole epilogue costs);
  * `no_halo_fetch`: the next box's halo is not loaded (its words are
    the previous box's);
  * `no_store`: the staged box is not written to the output;
  * `no_mma`: the mma instructions replaced by one xor of their operands;
  * `no_box_barriers`: the two CTA barriers of each box's iteration gone
    (racy: times the barriers, nothing else);
  * `three_per_sm`, `four_per_sm`: launch bounds for 3 or 4 CTAs of 256
    threads per SM instead of 2 (fewer registers, spilled if need be).
Of the wgmma route (conv2a, conv3a, conv3b):
  * `wgmma_no_epilogue`: the staged bytes are the sums' low bytes;
  * `wgmma_no_store`: the staged box is not written to the output.
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

from chip_smoke import card_line, cuda_ms  # noqa: E402
from recurrent_gaze_prediction_tpu_torch.ops.kernels import build  # noqa: E402
from recurrent_gaze_prediction_tpu_torch.ops.kernels import (  # noqa: E402
    conv3d_int8 as q1)

SOURCE = "conv3d_int8.cu"
CLIPS = 160
LAYERS = {"conv1a": ((16, 112, 112, 3), 64), "conv2a": ((16, 56, 56, 64), 128),
          "conv3b": ((8, 28, 28, 256), 256), "conv5a": ((2, 7, 7, 512), 512)}
HALO_STAGE = (
    "          stage_pair<kF32>(staged + r * kPitch + col * kEsize,\n"
    "                           dequant_relu<true>(acc[ni][2 * half], alpha[ni][0], bb[ni][0]),\n"
    "                           dequant_relu<true>(acc[ni][2 * half + 1], alpha[ni][1], bb[ni][1]),\n"
    "                           rq);\n")
# name: (layers timed, exact, replacements)
VARIANTS = {
    "no_requant": (["conv1a"], False, [(HALO_STAGE, (
        "          *reinterpret_cast<uint16_t*>(staged + r * kPitch + col * "
        "kEsize) = (uint16_t)(\n"
        "              (int)dequant_relu<true>(acc[ni][2 * half], alpha[ni][0], "
        "bb[ni][0]) |\n"
        "              ((int)dequant_relu<true>(acc[ni][2 * half + 1], "
        "alpha[ni][1], bb[ni][1]) << 8));\n"))]),
    "no_epilogue": (["conv1a"], False, [(HALO_STAGE, (
        "          *reinterpret_cast<uint16_t*>(staged + r * kPitch + col * "
        "kEsize) =\n              (uint16_t)(acc[ni][2 * half] ^ "
        "(acc[ni][2 * half + 1] << 8));\n"))]),
    "no_halo_fetch": (["conv1a"], False, [(
        "      fetch_halo(g, x, nn, nd0, nh0, nw0, hc, bytes);\n    }",
        "    }")]),
    "no_store": (["conv1a"], False, [(
        "      if (od < g.D && oh < g.H && ow < g.W) {",
        "      if (od < 0) {")]),
    "wgmma_no_epilogue": (["conv2a", "conv3a", "conv3b"], False, [(
        "      stage_pair<kF32>(smem + (row + 8 * half) * kPitch + col * kEsize,\n"
        "                       dequant_relu(acc[4 * j + 2 * half], a.x, b.x),\n"
        "                       dequant_relu(acc[4 * j + 2 * half + 1], a.y, b.y), rq);\n",
        "      *reinterpret_cast<uint16_t*>(smem + (row + 8 * half) * kPitch + "
        "col * kEsize) =\n          (uint16_t)(acc[4 * j + 2 * half] ^ "
        "(acc[4 * j + 2 * half + 1] << 8));\n")]),
    "wgmma_no_store": (["conv2a", "conv3a", "conv3b"], False, [(
        "  store_box(smem, kPitch, BN * kEsize,",
        "  if (n < 0) store_box(smem, kPitch, BN * kEsize,")]),
    "no_mma": (["conv1a"], False, [(
        "        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[ni], a, bf[ni][kc]);",
        "        for (int ni = 0; ni < 4; ++ni) acc[ni][kc] ^= a[ni] ^ "
        "bf[ni][kc][0];")]),
    "no_box_barriers": (["conv1a"], False, [(
        "    }\n    __syncthreads();\n#pragma unroll\n    for (int k = 0; k < "
        "kOutPerThread; ++k) {",
        "    }\n#pragma unroll\n    for (int k = 0; k < kOutPerThread; ++k) {"),
        ("      }\n    }\n    __syncthreads();\n  }\n}",
         "      }\n    }\n  }\n}")]),
    "three_per_sm": (["conv1a"], True, [(
        "__global__ void __launch_bounds__(kHaloThreads, 2)",
        "__global__ void __launch_bounds__(kHaloThreads, 3)")]),
    "four_per_sm": (["conv1a"], True, [(
        "__global__ void __launch_bounds__(kHaloThreads, 2)",
        "__global__ void __launch_bounds__(kHaloThreads, 4)")]),
}


def variant_source(replacements: list) -> str:
    text = (build.CSRC_DIR / SOURCE).read_text()
    for old, new in replacements:
        if text.count(old) != 1:
            raise RuntimeError(f"{old!r} appears {text.count(old)} times in "
                               f"{SOURCE}, not once")
        text = text.replace(old, new)
    return text


def build_variants(names: list) -> dict:
    """{name: library} for the committed kernels and each variant."""
    libs = {"committed": build.load()}
    out = build.BUILD_DIR / "q1_variants"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    others = [s for s in build._sources() if s.name != SOURCE]
    compile_ = [nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR), "-c"]
    sources = []
    for name in names:
        src = out / f"conv3d_int8_{name}.cu"
        src.write_text(variant_source(VARIANTS[name][2]))
        sources.append(src)
    objects = [out / f"{s.stem}.o" for s in others + sources]
    build._run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True))
                for cmd in ([*compile_, "-o", str(o), str(s)]
                            for s, o in zip(others + sources, objects))])
    for name, obj in zip(names, objects[len(others):]):
        lib = out / f"librgp_kernels-{name}.so"
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                "-o", str(lib), *map(str, objects[:len(others)]), str(obj)]
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


def main(argv: list) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    names = argv or list(VARIANTS)
    card = card_line()
    print(card, flush=True)
    libs = build_variants(names)
    rng = np.random.RandomState(7)
    times = {}
    for layer, ((d, h, w, cin), cout) in LAYERS.items():
        mine = ["committed"] + [n for n in names if layer in VARIANTS[n][0]]
        if len(mine) == 1:
            continue
        x = torch.from_numpy(rng.randint(-20, 21, (CLIPS, d, h, w, cin))
                             .astype(np.int8)).cuda()
        wq = torch.from_numpy(q1.pack_weights(rng.randint(
            -127, 128, (cout, cin, 3, 3, 3)).astype(np.int8))).cuda()
        wscale = torch.from_numpy((rng.rand(cout) * 1e-4 + 1e-5).astype(
            np.float32)).cuda()
        b = torch.from_numpy((rng.randn(cout) * 0.1).astype(
            np.float32)).cuda()
        args = (x, wq, wscale, b, 0.0123, 0.05)
        with torch.inference_mode():
            outs = {n: run_with(libs[n], lambda: q1.conv3d_int8(*args))
                    for n in mine}
            for n in mine[1:]:
                if VARIANTS[n][1] and not torch.equal(outs[n],
                                                      outs["committed"]):
                    print(f"{layer} {n}: differs from the committed kernel",
                          flush=True)
                    return 1
            del outs
            ms = {n: [] for n in mine}
            for n in mine + mine[1:][::-1] + mine[:1]:
                ms[n].append(run_with(libs[n], lambda: cuda_ms(
                    lambda: q1.conv3d_int8(*args), 5)))
        times[layer] = {n: float(np.mean(v)) for n, v in ms.items()}
        gop = q1.conv_ops(tuple(x.shape), cout) / 1e9
        print(f"{layer} x {list(x.shape)} -> {cout}: " + ", ".join(
            f"{n} {t:.4f} ms ({gop / t:.1f} TOP/s)"
            for n, t in times[layer].items()) + f" [{card}]", flush=True)
        del x
        torch.cuda.empty_cache()
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
