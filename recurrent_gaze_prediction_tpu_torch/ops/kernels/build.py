"""Build the port's CUDA kernels at first use and load them with ctypes.

`load()` compiles every `csrc/*.cu` with `nvcc` into one shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
under `_build/` in the package (listed in .gitignore), and loads it. The
library's name carries a hash of the sources and flags, so an edited
source is rebuilt. The first CUDA tensor that reaches a kernel triggers
the build; a failed build raises with the compiler's output.
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

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.convgru_fwd.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i, i, i, vp]
    lib.convgru_fwd.restype = i
    lib.convgru_fwd_smem_bytes.argtypes = [i, i, i, i]
    lib.convgru_fwd_smem_bytes.restype = ctypes.c_size_t
    lib.convgru_fwd_smem_limit.argtypes = []
    lib.convgru_fwd_smem_limit.restype = ctypes.c_size_t
    lib.convgru_fwd_error_string.argtypes = [i]
    lib.convgru_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _build() -> ctypes.CDLL:
    sources = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"librgp_kernels-{digest.hexdigest()[:16]}.so"
    start = time.perf_counter()
    log = ""
    if not out.exists():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
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
