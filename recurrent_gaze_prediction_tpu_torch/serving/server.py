"""HTTP inference server: npz in, gaze maps out, dynamically batched.

The port's counterpart of the JAX package's `serving/server.py`: a
stdlib-only (http.server) front-end over `DynamicBatcher`. Concurrent POSTs
are coalesced into single device calls; each request thread blocks on its
Future while the batcher fills a window.

Protocol (the same as the JAX package's):
  GET  /healthz   -> {"status": "ok", "calls": N, "requests": M, "inputs": [...]}
  POST /predict   -> body: .npz with `frames` [T,H,W,3] and `c3d`
                     [T,1024,7,7], ONE clip without a batch dimension;
                     response: .npz with `gazemaps` [T,GH,GW].
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..utils import log
from .batcher import DynamicBatcher
from .bundle import WIRE_DTYPES, load_bundle, program_meta, read_manifest

# Programs of the JAX package's bundles that the port does not serve yet,
# and the ROADMAP.md item that brings each.
_NOT_PORTED = {
    "stream": "ROADMAP.md queue A item 7 (the streaming step)",
    "fused": "ROADMAP.md queue A item 10 (the raw-video front)",
    "fused_int8": "ROADMAP.md queue A item 11 (the int8 C3D tower)",
}


def _as_float32(key: str, a: np.ndarray) -> np.ndarray:
    """A request array as float32, or ValueError (-> 400). Clients send
    f32/f16 (numpy cannot carry bfloat16 in an npz); a bfloat16 bundle
    rounds on the device."""
    if a.dtype.kind not in "fiu":
        raise ValueError(f"input {key}: dtype {a.dtype} is not a real "
                         f"number type (send float32/float16 values)")
    return a.astype(np.float32, copy=False)


class GazeServer:
    """Wraps `predict_fn(*batched_arrays) -> batched maps` in an HTTP
    endpoint with dynamic micro-batching.

    `input_keys` fixes the npz keys (and their order) a request must carry.
    `input_ndims` maps key -> expected UNBATCHED ndim and `input_shapes`
    key -> expected UNBATCHED shape (None entries are wildcards); a request
    violating either gets its own 400 instead of failing the whole
    micro-batch it would have joined.
    """

    def __init__(self, predict_fn: Callable,
                 input_keys: Sequence[str] = ("frames", "c3d"), *,
                 host: str = "127.0.0.1", port: int = 0,
                 max_batch: int = 32, max_wait_ms: float = 5.0,
                 input_ndims: Optional[dict] = None,
                 input_shapes: Optional[dict] = None,
                 max_body_bytes: int = 256 * 1024 * 1024,
                 request_timeout: float = 120.0):
        self.input_keys = tuple(input_keys)
        self.input_ndims = dict(input_ndims or {})
        self.input_shapes = {k: tuple(v)
                             for k, v in (input_shapes or {}).items()}
        self.batcher = DynamicBatcher(predict_fn, max_batch=max_batch,
                                      max_wait_ms=max_wait_ms)
        server = self

        class Handler(BaseHTTPRequestHandler):
            timeout = request_timeout  # a client lying about
            # Content-Length must not pin a handler thread forever

            def log_message(self, fmt, *args):  # route through our logger
                log.info("http: " + fmt, *args)

            def _reply(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _reply_json(self, code: int, obj) -> None:
                self._reply(code, json.dumps(obj).encode(),
                            "application/json")

            def do_GET(self):
                if self.path != "/healthz":
                    return self._reply_json(404, {"error": "not found"})
                self._reply_json(200, {
                    "status": "ok",
                    "calls": server.batcher.calls,
                    "requests": server.batcher.requests,
                    "inputs": list(server.input_keys),
                })

            def do_POST(self):
                if self.path != "/predict":
                    return self._reply_json(404, {"error": "not found"})
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    if length > max_body_bytes:
                        return self._reply_json(413, {
                            "error": f"body {length} bytes exceeds the "
                                     f"{max_body_bytes} limit"})
                    blob = np.load(io.BytesIO(self.rfile.read(length)),
                                   allow_pickle=False)
                    try:
                        arrays = [blob[k] for k in server.input_keys]
                    except KeyError as e:
                        return self._reply_json(400, {
                            "error": f"missing input {e}; need "
                                     f"{list(server.input_keys)}"})
                    for k, a in zip(server.input_keys, arrays):
                        want = server.input_ndims.get(k)
                        if want is not None and a.ndim != want:
                            return self._reply_json(400, {
                                "error": f"input {k} must be {want}-D "
                                         f"(ONE clip, no batch dim); got "
                                         f"shape {list(a.shape)}"})
                        want_shape = server.input_shapes.get(k)
                        if want_shape is not None and (
                                len(a.shape) != len(want_shape) or any(
                                    w is not None and d != w
                                    for d, w in zip(a.shape, want_shape))):
                            return self._reply_json(400, {
                                "error": f"input {k} must have unbatched "
                                         f"shape {list(want_shape)} (None ="
                                         f" any); got {list(a.shape)}"})
                    arrays = [_as_float32(k, a)
                              for k, a in zip(server.input_keys, arrays)]
                except Exception as e:
                    return self._reply_json(400, {"error": str(e)})
                try:
                    maps = server.batcher.predict(*arrays)
                except Exception as e:
                    return self._reply_json(500, {"error": str(e)})
                out = io.BytesIO()
                np.savez_compressed(out, gazemaps=np.asarray(maps))
                self._reply(200, out.getvalue(), "application/octet-stream")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None
        self._serving = False

    @property
    def address(self) -> tuple[str, int]:
        return self._httpd.server_address[:2]

    def start(self) -> "GazeServer":
        """Serve on a daemon thread; returns self (address is then bound)."""
        self._serving = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="rgp-http")
        self._thread.start()
        log.infov("serving on http://%s:%d (inputs: %s)", *self.address,
                  ",".join(self.input_keys))
        return self

    def serve_forever(self) -> None:
        log.infov("serving on http://%s:%d (inputs: %s)", *self.address,
                  ",".join(self.input_keys))
        self._serving = True
        self._httpd.serve_forever()

    def close(self) -> None:
        # BaseServer.shutdown() waits on an event only serve_forever sets;
        # calling it on a never-started server would block forever
        if self._serving:
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self.batcher.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def server_from_bundle(bundle_dir: str, *, program: str = "predict",
                       host: str = "127.0.0.1", port: int = 0,
                       max_batch: int = 32, max_wait_ms: float = 5.0,
                       device=None) -> GazeServer:
    """Serve a bundle written by either package's `save_bundle` on
    `device` (None = the card). Only the feature-fed `predict` program is
    ported: (frames, c3d) -> maps. The batcher pads each coalesced batch to
    a power-of-two bucket."""
    if program in _NOT_PORTED:
        raise ValueError(f"program {program!r} is not ported yet: "
                         f"{_NOT_PORTED[program]}")
    if program != "predict":
        raise ValueError(f"program must be predict, got {program!r}")
    manifest = read_manifest(bundle_dir)
    meta = program_meta(manifest, "predict")
    model = load_bundle(bundle_dir, device=device)
    cfg = model.cfg
    dev = next(model.parameters()).device
    wire = WIRE_DTYPES[meta.get("wire_dtype", "float32")]
    t = meta.get("t", cfg.n_lstm_steps)

    def predict_fn(frames: np.ndarray, c3d: np.ndarray) -> np.ndarray:
        # frames stay on the host: gaze_grcn does not read them
        feats = torch.from_numpy(c3d).to(dev).to(wire).float()
        return model.predict(torch.from_numpy(frames), feats).cpu().numpy()

    return GazeServer(
        predict_fn, ("frames", "c3d"), host=host, port=port,
        max_batch=max_batch, max_wait_ms=max_wait_ms,
        input_ndims={"frames": 4, "c3d": 4},
        input_shapes={"frames": (t, cfg.image_height, cfg.image_width, 3),
                      "c3d": (t, cfg.dim_feature, 7, 7)})
