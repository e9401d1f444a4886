"""Build the port's CUDA kernels at first use and load them with ctypes.

`load()` compiles every `csrc/*.cu` with `nvcc` (one process per source,
all started together) and links them into one shared library with a plain
C interface (no PyTorch headers, so a build takes seconds), under `_build/`
in the package (listed in .gitignore), and loads it. The library's name
carries a hash of the sources, the shared headers (`csrc/*.cuh`) and the
flags, so an edited source is rebuilt. The first CUDA tensor that reaches a
kernel triggers the build; a failed build raises with the compiler's
output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# what the last build in this process did: {"seconds", "log", "path"}
last_build: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    candidates.append(shutil.which("nvcc") or "")
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    sources = sorted(CSRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return sources


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i, size = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    lib.convgru_fwd.argtypes = [vp] * 6 + [i] * 6 + [vp]
    lib.convgru_bwd.argtypes = [vp] * 10 + [i] * 6 + [vp]
    lib.convgru_bwd_gates.argtypes = [vp] * 10 + [i] * 6 + [vp]
    lib.convgru_wgrad.argtypes = [vp] * 6 + [i] * 6 + [vp]
    lib.convlstm_fwd.argtypes = [vp] * 10 + [i] * 6 + [vp]
    # B5: pointers, then T, B, H, W, K, U, stream
    lib.convgru_small_fwd.argtypes = [vp] * 5 + [i] * 6 + [vp]
    lib.convgru_small_bwd.argtypes = [vp] * 11 + [i] * 6 + [vp]
    lib.convgru_small_smem_bytes.argtypes = [i] * 5
    lib.convgru_small_smem_bytes.restype = size
    # B6: pointers, then T, B, H, W, U, stream
    lib.convgru_grid_fwd.argtypes = [vp] * 8 + [i] * 5 + [vp]
    lib.convgru_grid_bwd.argtypes = [vp] * 11 + [i] * 5 + [vp]
    lib.convgru_grid_smem_bytes.argtypes = [i] * 4
    lib.convgru_grid_smem_bytes.restype = size
    lib.convgru_grid_max_ctas.argtypes = [i] * 4
    lib.convgru_grid_max_ctas.restype = i
    # M1: each operand's pointer, dims (inner, planes, outer), strides
    # (plane, outer), trans, seg; then C, its rows, columns and row
    # stride, R, segments, splits, stream
    ll = ctypes.c_longlong
    operand = [vp] + [ll] * 5 + [i] * 2
    lib.gemm_bf16.argtypes = (operand * 2 + [vp] + [i] * 2 + [ll] * 2
                              + [i] * 2 + [vp])
    f = ctypes.c_float
    # x, w, wscale, b, xscale, xscale_next, out_f32, out, N, D, H, W, Cin,
    # Cout, K, the box (bd, bh, bw), bn, stages, stream
    lib.conv3d_int8.argtypes = [vp] * 4 + [f, f, i, vp] + [i] * 12 + [vp]
    lib.conv3d_int8_ctas_per_sm.argtypes = [i] * 4
    lib.conv3d_int8_ctas_per_sm.restype = i
    lib.maxpool3d_int8.argtypes = [vp] * 2 + [i] * 17 + [vp]
    for name in ("convgru_fwd_smem_bytes", "convgru_bwd_smem_bytes",
                 "convgru_bwd_gates_smem_bytes", "convgru_wgrad_smem_bytes",
                 "convlstm_fwd_smem_bytes"):
        getattr(lib, name).argtypes = [i, i, i, i]
        getattr(lib, name).restype = size
    for name in ("convgru_fwd_max_clusters", "convgru_bwd_max_clusters",
                 "convlstm_fwd_max_clusters"):
        getattr(lib, name).argtypes = [i, i, i, i]
        getattr(lib, name).restype = i
    lib.convgru_wgrad_tiles.argtypes = [i] * 4
    lib.convgru_wgrad_slices.argtypes = [i] * 5
    for name in ("convgru_wgrad_tiles", "convgru_wgrad_slices"):
        getattr(lib, name).restype = i
    for name in ("convgru_fwd", "convgru_bwd", "convgru_bwd_gates",
                 "convgru_wgrad", "convlstm_fwd", "conv3d_int8",
                 "maxpool3d_int8", "convgru_small_fwd", "convgru_small_bwd",
                 "convgru_grid_fwd", "convgru_grid_bwd", "gemm_bf16"):
        getattr(lib, name).restype = i
    for name in ("convgru_fwd_error_string", "convlstm_fwd_error_string",
                 "conv3d_int8_error_string", "maxpool3d_int8_error_string"):
        getattr(lib, name).argtypes = [i]
        getattr(lib, name).restype = ctypes.c_char_p
    return lib


def _run(procs: list) -> str:
    """Wait for every (cmd, Popen); raise with the first failure's output."""
    logs, failed = [], None
    for cmd, proc in procs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, out)
    if failed is not None:
        cmd, rc, out = failed
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")
    return "".join(logs)


def _build() -> ctypes.CDLL:
    sources = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"librgp_kernels-{digest.hexdigest()[:16]}.so"
    start = time.perf_counter()
    log = ""
    if not out.exists():
        nvcc = _nvcc()
        tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
        objects = [BUILD_DIR / f"{src.stem}-{tag}.o" for src in sources]
        log = _run([(cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                        for src, obj in zip(sources, objects))])
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                "-o", str(tmp), *map(str, objects)]
        log += _run([(link, subprocess.Popen(
            link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))])
        for obj in objects:
            obj.unlink()
        os.replace(tmp, out)
    lib = _declare(ctypes.CDLL(str(out)))
    last_build.update(seconds=time.perf_counter() - start, log=log,
                      path=str(out))
    return lib


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on the first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _build()
        return _lib


def launch(kernel: str, device: torch.device, *args) -> None:
    """Call the library's `kernel(*args, stream)` on the current stream of
    `device`, with that device bound: the batcher launches from its worker
    thread and autograd runs the backward on its own thread, so neither
    the thread's current device nor its stream can be relied on. Raises if
    the launch failed. Temporaries the caller made on that stream may be
    freed as soon as this returns: the caching allocator hands their memory
    out again only in that stream's order, after the kernel."""
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, kernel)(*args, stream)
    if err != 0:
        describe = getattr(lib, f"{kernel}_error_string",
                           lib.convgru_fwd_error_string)
        raise RuntimeError(f"{kernel} launch failed: "
                           f"{describe(err).decode()}")


def same_device(kernel: str, *tensors: torch.Tensor) -> torch.device:
    """The one device all of a kernel's inputs lie on; raises otherwise."""
    devices = {x.device for x in tensors}
    if len(devices) != 1:
        raise ValueError(f"{kernel} inputs on several devices: "
                         f"{sorted(map(str, devices))}")
    return devices.pop()
