"""ctypes bindings for the native host libraries: the port's counterpart of
the JAX package's `native/__init__.py`.

`blobio.cc` (the C3D blob codec and a threaded batch reader) and
`framedec.cc` (a threaded libjpeg batch decoder with a bilinear resize)
are compiled with g++ at first use, framedec with `-ljpeg`, into the
package's `_build/` (listed in .gitignore; the name carries a hash of the
source and flags). No shared library is kept in the repository. When a
library cannot be built (no g++, no libjpeg headers), every entry point
falls back, with one warning, to the pure-Python path: the NumPy codec
(`data/codec.py`) or PIL. `build_status()` says which path a library
takes. These are host libraries; nothing here touches the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..utils import log

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build"
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
_LIBS = {"blobio": ("blobio.cc", ("-lpthread",)),
         "framedec": ("framedec.cc", ("-lpthread", "-ljpeg"))}

_lock = threading.Lock()
_loaded: dict = {}       # name -> CDLL, or None once a build failed
_reasons: dict = {}      # name -> why it fell back


def _build(name: str) -> Path:
    source, libs = _LIBS[name]
    src = _DIR / source
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    digest = hashlib.sha256(src.read_bytes() + " ".join(
        CXXFLAGS + libs).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *CXXFLAGS, str(src), "-o", str(tmp),
                               *libs], capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{cxx} failed ({proc.returncode}): "
                               f"{proc.stderr.strip()[-500:]}")
        os.replace(tmp, out)
    return out


def _declare(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p = ctypes.POINTER(ctypes.c_int32)
    if name == "blobio":
        lib.blobio_read_header.argtypes = [ctypes.c_char_p, i32p]
        lib.blobio_read.argtypes = [ctypes.c_char_p, i32p,
                                    ctypes.POINTER(ctypes.c_float),
                                    ctypes.c_int64]
        lib.blobio_write.argtypes = [ctypes.c_char_p, i32p,
                                     ctypes.POINTER(ctypes.c_float)]
        lib.blobio_read_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), i32p, ctypes.c_int]
        for fn in (lib.blobio_read_header, lib.blobio_read,
                   lib.blobio_write, lib.blobio_read_batch):
            fn.restype = ctypes.c_int
    else:
        lib.framedec_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), i32p, ctypes.c_int]
        lib.framedec_decode_batch.restype = ctypes.c_int
    return lib


def _load(name: str) -> Optional[ctypes.CDLL]:
    with _lock:
        if name not in _loaded:
            try:
                _loaded[name] = _declare(name, ctypes.CDLL(str(_build(name))))
            except Exception as e:  # the documented fallback
                _loaded[name] = None
                _reasons[name] = str(e).splitlines()[0] if str(e) else \
                    type(e).__name__
                log.warn("native %s unavailable (%s); using the Python "
                         "fallback", name, _reasons[name])
        return _loaded[name]


def get_lib() -> Optional[ctypes.CDLL]:
    """The blob codec library, built on first use; None when it cannot be
    built."""
    return _load("blobio")


def get_framedec() -> Optional[ctypes.CDLL]:
    """The JPEG batch decoder library, built on first use; None when it
    cannot be built."""
    return _load("framedec")


def available() -> bool:
    return get_lib() is not None


def framedec_available() -> bool:
    return get_framedec() is not None


def build_status() -> dict:
    """{library: "built" | "fallback (<reason>)"}, building each first."""
    return {name: "built" if _load(name) is not None
            else f"fallback ({_reasons[name]})" for name in _LIBS}


def read_blob(path: str) -> np.ndarray:
    """Native single-blob read; NumPy fallback otherwise."""
    lib = get_lib()
    if lib is None:
        from ..data import codec
        return codec.read_binary_blob(path)
    shape = (ctypes.c_int32 * 5)()
    rc = lib.blobio_read_header(path.encode(), shape)
    if rc != 0:
        raise IOError(f"blobio_read_header({path}) -> {rc}")
    out = np.empty(tuple(shape), np.float32)
    rc = lib.blobio_read(path.encode(), shape,
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                         out.size)
    if rc != 0:
        raise IOError(f"blobio_read({path}) -> {rc}")
    return out


def write_blob(path: str, blob: np.ndarray) -> None:
    """Native single-blob write of a 5-D array; NumPy fallback
    otherwise."""
    lib = get_lib()
    if lib is None:
        from ..data import codec
        codec.write_binary_blob(path, blob)
        return
    blob = np.ascontiguousarray(blob, np.float32)
    if blob.ndim != 5:
        raise ValueError(f"a blob is 5-D, got shape {blob.shape}")
    shape = (ctypes.c_int32 * 5)(*blob.shape)
    rc = lib.blobio_write(path.encode(), shape,
                          blob.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise IOError(f"blobio_write({path}) -> {rc}")


def read_blob_batch(paths: Sequence[str], blob_shape: Sequence[int],
                    n_threads: int = 8) -> np.ndarray:
    """Decode many same-shape blob files in parallel ->
    [len(paths), *blob_shape]. Raises IOError naming the first failing
    files."""
    blob_shape = tuple(blob_shape)
    lib = get_lib()
    if lib is None:
        from ..data import codec
        return np.stack([codec.read_binary_blob(p).reshape(blob_shape)
                         for p in paths])
    n = len(paths)
    out = np.empty((n,) + blob_shape, np.float32)
    statuses = np.zeros(n, np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    failures = lib.blobio_read_batch(
        c_paths, n, int(np.prod(blob_shape)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        statuses.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n_threads)
    if failures:
        bad = [paths[i] for i in np.nonzero(statuses)[0]]
        raise IOError(f"blobio_read_batch: {failures} failures, "
                      f"e.g. {bad[:3]}")
    return out


def decode_jpeg_batch(paths: Sequence[str], out_hw: tuple[int, int],
                      n_threads: int = 8) -> np.ndarray:
    """Threaded native JPEG batch decode (+ bilinear resize) ->
    [N, H, W, 3] uint8. Decode-only (source size == out size) is
    bit-identical to PIL (same libjpeg); resized output uses
    half-pixel-centre bilinear (cv2 semantics), within a few steps of PIL's
    antialiased BILINEAR. Raises IOError naming the first failing files.
    Falls back to PIL when the library cannot be built."""
    lib = get_framedec()
    if lib is None:
        from PIL import Image

        frames = []
        for p in paths:
            img = Image.open(p).convert("RGB")
            if img.size != (out_hw[1], out_hw[0]):
                img = img.resize((out_hw[1], out_hw[0]), Image.BILINEAR)
            frames.append(np.asarray(img))
        return np.stack(frames)
    n = len(paths)
    out = np.empty((n, out_hw[0], out_hw[1], 3), np.uint8)
    statuses = np.zeros(n, np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    failures = lib.framedec_decode_batch(
        c_paths, n, out_hw[0], out_hw[1],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        statuses.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n_threads)
    if failures:
        bad = [paths[i] for i in np.nonzero(statuses)[0]]
        raise IOError(f"decode_jpeg_batch: {failures} failures, "
                      f"e.g. {bad[:3]}")
    return out
