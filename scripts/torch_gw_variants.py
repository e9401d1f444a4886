#!/usr/bin/env python3
"""Time variants of B4's phases G (`csrc/convgru_bwd_gates.cu`) and W
(`csrc/convgru_wgrad.cu`) against the kernels as committed, on one NVIDIA
card.

    python3 scripts/torch_gw_variants.py [VARIANT ...]   # from the repo root

A variant is a committed source with a few lines replaced; each
replacement must match exactly once, so an edited source fails here
instead of timing something else. The variants are built with the other
kernels into their own libraries under the package's `_build/` (one nvcc
per source, all at once), then launched through the wrappers with their
library swapped in. Most take a part of their kernel away to show what
that part costs; G's outputs are printed beside the plain version's
(largest deviation over the output's scale) for every variant. G and W
run on the inputs of a real forward (`parity.backward_inputs`: T=42,
U=128, bf16) at B=8 and 28, timed with CUDA events in turns: committed,
variants, variants reversed, committed. The last line is a JSON object of
the times in ms.

Variants of G:
  * `g_no_epilogue`: the gates' epilogues write nothing (the sums are
    kept alive by a store no run takes);
  * `g_no_mma`: the wgmma replaced by an add of one A register (ldmatrix,
    the ring and the epilogues stay);
  * `g_no_frame`: a frame's staged h is not rounded into the padded
    buffer nor written out as hprev;
  * `g_mma_only`: the K loops wait for no weight chunk (none is loaded:
    the products run on whatever the ring holds);
  * `g_no_weight_tma`: the weight chunks are not loaded (the producer
    only arrives on the ring's barriers);
  * `g_timeline`: thread 0 of CTA 0 stamps clock64 before and after each
    K loop and at the ends of a pair (printed as deltas; the times include
    the stamps);
  * `g_stages2`, `g_stages3`: a weight ring of 2 or 3 stages.
Of W:
  * `w_no_mma`: the wgmma replaced by an add of the descriptors;
  * `w_no_convert`: nothing rounded into the operand tiles (the TMA ring
    and the products stay);
  * `w_timeline`: thread 0 of CTA 0 stamps clock64 around each barrier,
    the f32 wait and the rounding of a frame (printed as deltas).
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
    convgru_vjp as v1, convgru_vjp2 as v2)
from recurrent_gaze_prediction_tpu_torch.ops.kernels.parity import (  # noqa: E402
    backward_inputs)

G, W = "convgru_bwd_gates.cu", "convgru_wgrad.cu"
BATCHES = (8, 28)
# the gates' epilogues write nothing (the sums kept alive by a store no
# run takes)
EPILOGUE_OFF = [
        ("        named_sync(1 + wg, 128);  // every warp is done reading h "
         "before r*h may replace it\n        if (!live) continue;\n",
         "        named_sync(1 + wg, 128);  // every warp is done reading h "
         "before r*h may replace it\n        if (live && acc[0] == 1.25e-37f)"
         " u_s[0] = acc[BN1 / 2 - 1];\n        continue;\n"),
        ("        conv_tile<BN2>(acc, rhpad, m, q, ring, kStage, full, empty, "
         "s);\n        if (!live) continue;\n",
         "        conv_tile<BN2>(acc, rhpad, m, q, ring, kStage, full, empty, "
         "s);\n        if (live && acc[0] == 1.25e-37f) c_s[0] = "
         "acc[BN2 / 2 - 1];\n        continue;\n")]
# name: (source, replacements)
VARIANTS = {
    "g_no_epilogue": (G, EPILOGUE_OFF),
    "g_no_mma": (G, [
        ("      WgmmaRS<BN>::mma(acc, ak[j], desc_sw128(b + 32 * j, 16, 1024));\n",
         "      acc[j] += __uint_as_float(ak[j][0] ^ b);\n")]),
    "g_no_frame": (G, [
        ("      for (int e = wtid; e < hw * q4; e += 128) {",
         "      for (int e = wtid; e < 0; e += 128) {")]),
    "g_no_weight_tma": (G, [
        ("        mbar_expect_tx(&full[st], bytes);\n"
         "        tma_load_2d(ring + (size_t)st * kStage, map, &full[st], k0, n0);\n",
         "        mbar_arrive(&full[st]);\n")]),
    "g_mma_only": (G, [
        ("    mbar_wait(&full[st], (s / q.stages) & 1);\n    const uint32_t b = smem_u32(",
         "    const uint32_t b = smem_u32("),
        ("        const int st = s % q.stages;\n"
         "        mbar_wait(&empty[st], ((s / q.stages) & 1) ^ 1);\n",
         "        if (s >= 0) return;\n        const int st = s % q.stages;\n"
         "        mbar_wait(&empty[st], ((s / q.stages) & 1) ^ 1);\n")]),
    "g_timeline": (G, [
        ("using namespace rgpc;\n",
         "using namespace rgpc;\n__device__ long long g_tl[256];\n"
         "#define STAMP() do { if (blockIdx.x == 0 && threadIdx.x == 0 && "
         "tl < 256) g_tl[tl++] = clock64(); } while (0)\n"),
        ("  int s = 0, i = 0;\n  for (int pair = blockIdx.x;",
         "  int s = 0, i = 0, tl = 0;\n  for (int pair = blockIdx.x;"),
        ("    // z|r conv, then u, r and r*h (f32 out, rounded into rhpad); sums at\n",
         "    STAMP();\n    // z|r conv, then u, r and r*h (f32 out, rounded into rhpad); "
         "sums at\n"),
        ("        conv_tile<BN1>(acc, hpad, m, q, ring, kStage, full, empty, s);\n",
         "        STAMP();\n        conv_tile<BN1>(acc, hpad, m, q, ring, kStage, full, "
         "empty, s);\n        STAMP();\n"),
        ("        conv_tile<BN2>(acc, rhpad, m, q, ring, kStage, full, empty, s);\n",
         "        STAMP();\n        conv_tile<BN2>(acc, rhpad, m, q, ring, kStage, full, "
         "empty, s);\n        STAMP();\n"),
        ("    named_sync(1 + wg, 128);  // every warp is done with r*h before the next "
         "frame's h\n",
         "    STAMP();\n    named_sync(1 + wg, 128);  // every warp is done with r*h "
         "before the next frame's h\n"),
        ("extern \"C\" {\n",
         "extern \"C\" {\n\nint gates_timeline(long long* out) {\n"
         "  return (int)cudaMemcpyFromSymbol(out, g_tl, sizeof(g_tl));\n}\n")]),
    "g_stages2": (G, [
        ("  q.stages = (int)(s > kMaxStages ? kMaxStages : (s < 2 ? 2 : s));",
         "  q.stages = 2;")]),
    "g_stages3": (G, [
        ("  q.stages = (int)(s > kMaxStages ? kMaxStages : (s < 2 ? 2 : s));",
         "  q.stages = 3;")]),
    "w_no_mma": (W, [
        ("        wgmma_ss_mn_64(acc[dx], desc_sw128(a, 1024, 1024), db);",
         "        acc[dx][0] += (float)(a ^ (uint32_t)db);")]),
    "w_timeline": (W, [
        ("using namespace rgpc;\n",
         "using namespace rgpc;\n__device__ long long w_tl[256];\n"
         "#define STAMP() do { if (blockIdx.x == 0 && threadIdx.x == 0 && "
         "tl < 256) w_tl[tl++] = clock64(); } while (0)\n"),
        ("  for (int i = 0; i < nf; ++i) {\n    const int st = i % kStages;\n",
         "  int tl = 0;\n  for (int i = 0; i < nf; ++i) {\n    STAMP();\n"
         "    const int st = i % kStages;\n"),
        ("    wgmma_wait<1>();\n    __syncthreads();\n"
         "    mbar_wait(&full[st], (i / kStages) & 1);\n",
         "    wgmma_wait<1>();\n    STAMP();\n    __syncthreads();\n    STAMP();\n"
         "    mbar_wait(&full[st], (i / kStages) & 1);\n    STAMP();\n"),
        ("    fence_proxy_async();\n    __syncthreads();  // the tiles are "
         "written and the stage is read\n",
         "    STAMP();\n    fence_proxy_async();\n    __syncthreads();  // the "
         "tiles are written and the stage is read\n    STAMP();\n"),
        ("extern \"C\" {\n",
         "extern \"C\" {\n\nint wgrad_timeline(long long* out) {\n"
         "  return (int)cudaMemcpyFromSymbol(out, w_tl, sizeof(w_tl));\n}\n")]),
    "w_no_convert": (W, [
        ("    for (int it = tid; it < 2 * q.hw * 8; it += kThreadsW) {",
         "    for (int it = tid; it < 0; it += kThreadsW) {")]),
}


def variant_source(source: str, replacements: list) -> str:
    text = (build.CSRC_DIR / source).read_text()
    for old, new in replacements:
        if text.count(old) != 1:
            raise RuntimeError(f"{old!r} appears {text.count(old)} times in "
                               f"{source}, not once")
        text = text.replace(old, new)
    return text


def build_variants(names: list) -> dict:
    """{name: library} for the committed kernels and each variant."""
    libs = {"committed": build.load()}
    out = build.BUILD_DIR / "gw_variants"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    compile_ = [nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR), "-c"]
    sources = build._sources()
    jobs = [(s, out / f"{s.stem}.o") for s in sources]
    for name in names:
        src = out / f"{name}.cu"
        src.write_text(variant_source(*VARIANTS[name]))
        jobs.append((src, out / f"{name}.o"))
    build._run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True))
                for cmd in ([*compile_, "-o", str(o), str(s)]
                            for s, o in jobs)])
    for name in names:
        replaced = VARIANTS[name][0]
        objects = [str(o) for s, o in jobs[:len(sources)]
                   if s.name != replaced] + [str(out / f"{name}.o")]
        lib = out / f"librgp_kernels-{name}.so"
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                "-o", str(lib), *objects]
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
    times = {}
    for b in BATCHES:
        x = backward_inputs(42, b, 512, 128, torch.bfloat16, b, "cuda")
        cdt = torch.bfloat16
        with torch.no_grad():
            dzr, da, _ = v2.dh_bwd(x["u"], x["r"], x["c"], x["hprev"],
                                   x["g"], x["uzr"], x["uc"], cdt)
        calls = {
            "G": lambda: v1.bwd_gates(x["uzr"], x["uc"], x["wx"], x["h0"],
                                      x["ys"]),
            "W": lambda: v1.wgrad(x["hprev"], dzr, x["rh"], da, cdt)}
        for phase, call in calls.items():
            mine = ["committed"] + [n for n in names
                                    if VARIANTS[n][0] == (G if phase == "G"
                                                          else W)]
            if len(mine) == 1:
                continue
            ms = {n: [] for n in mine}
            with torch.no_grad():
                for n in mine + mine[1:][::-1] + mine[:1]:
                    ms[n].append(run_with(libs[n],
                                          lambda: cuda_ms(call, 10)))
            times[f"{phase} B={b}"] = {n: float(np.mean(v))
                                       for n, v in ms.items()}
            if phase == "G":  # each output's largest deviation from plain
                with torch.no_grad():
                    want = v1.recompute_gates(x["uzr"], x["uc"], x["wx"],
                                              x["h0"], x["ys"])
                    for n in mine:
                        got = run_with(libs[n], call)
                        print(f"G B={b} {n}: max_rel " + ", ".join(
                            f"{float((k - a).abs().max() / a.abs().max()):.2e}"
                            for k, a in zip(got, want)), flush=True)
            print(f"{phase} B={b}: " + ", ".join(
                f"{n} {t:.4f} ms" for n, t in times[f'{phase} B={b}'].items())
                + f" [{card}]", flush=True)
    for name, fn in (("g_timeline", "gates_timeline"),
                     ("w_timeline", "wgrad_timeline")):
        if name in libs:
            buf = (ctypes.c_longlong * 256)()
            read = getattr(libs[name], fn)
            read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
            read(ctypes.addressof(buf))
            stamps = [v for v in buf if v]
            print(f"{name} deltas (clocks): " + json.dumps(
                [b - a for a, b in zip(stamps, stamps[1:])][:48]), flush=True)
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
