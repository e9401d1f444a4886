"""HTTP inference server: npz in, gaze maps out, dynamically batched.

The port's counterpart of the JAX package's `serving/server.py`: a
stdlib-only (http.server) front-end over `DynamicBatcher`. Concurrent POSTs
are coalesced into single device calls; each request thread blocks on its
Future while the batcher fills a window.

Protocol (the same as the JAX package's):
  GET  /healthz   -> {"status": "ok", "calls": N, "requests": M, "inputs": [...]}
  POST /predict   -> body: .npz with `frames` [T,H,W,3] and `c3d`
                     [T,1024,7,7] (the `predict` program), or `video`
                     [F,H,W,3] pixels (the `fused` and `fused_int8`
                     programs), ONE clip
                     without a batch dimension; response: .npz with
                     `gazemaps` [T,GH,GW].
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
from .bundle import (WIRE_DTYPES, fused_int8_predict_fn, fused_predict_fn,
                     load_bundle, program_meta, read_manifest)

# the raw-video programs: the bundle function that runs each and the
# `save_bundle` weights that record it. Neither package's server serves
# `stream`: it runs through the bundle's own API (`bundle.stream_step`).
_VIDEO_PROGRAMS = {"fused": (fused_predict_fn, "c3d_params"),
                   "fused_int8": (fused_int8_predict_fn, "int8_qparams")}


def _as_program_dtype(key: str, a: np.ndarray, want: np.dtype) -> np.ndarray:
    """A request array in the dtype the program takes on the wire, or
    ValueError (-> 400), as the JAX package's server casts. float32
    programs take any real input (numpy cannot carry bfloat16 in an npz,
    so a bfloat16 bundle rounds on the device). uint8 programs take
    integer pixels in 0..255 and refuse floats: a lossy float -> uint8
    round is the client's decision."""
    if want == np.float32:
        if a.dtype.kind not in "fiu":
            raise ValueError(f"input {key}: dtype {a.dtype} is not a real "
                             f"number type (send float32/float16 values)")
        return a.astype(np.float32, copy=False)
    if a.dtype.kind not in "iu":
        raise ValueError(f"input {key}: program expects uint8 pixels "
                         f"(0..255); got {a.dtype}")
    lo, hi = (int(a.min()), int(a.max())) if a.size else (0, 0)
    if lo < 0 or hi > 255:
        raise ValueError(f"input {key}: values [{lo},{hi}] out of uint8 "
                         f"range")
    return a.astype(np.uint8, copy=False)


class GazeServer:
    """Wraps `predict_fn(*batched_arrays) -> batched maps` in an HTTP
    endpoint with dynamic micro-batching.

    `input_keys` fixes the npz keys (and their order) a request must carry.
    `input_ndims` maps key -> expected UNBATCHED ndim and `input_shapes`
    key -> expected UNBATCHED shape (None entries are wildcards); a request
    violating either gets its own 400 instead of failing the whole
    micro-batch it would have joined. `input_dtypes` maps key -> "float32"
    (the default) or "uint8", the dtype a request is cast to and batched
    in.
    """

    def __init__(self, predict_fn: Callable,
                 input_keys: Sequence[str] = ("frames", "c3d"), *,
                 host: str = "127.0.0.1", port: int = 0,
                 max_batch: int = 32, max_wait_ms: float = 5.0,
                 input_ndims: Optional[dict] = None,
                 input_shapes: Optional[dict] = None,
                 input_dtypes: Optional[dict] = None,
                 max_body_bytes: int = 256 * 1024 * 1024,
                 request_timeout: float = 120.0):
        self.input_keys = tuple(input_keys)
        self.input_ndims = dict(input_ndims or {})
        self.input_shapes = {k: tuple(v)
                             for k, v in (input_shapes or {}).items()}
        dtypes = input_dtypes or {}
        self.input_dtypes = {k: np.dtype(dtypes.get(k, "float32"))
                             for k in self.input_keys}
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
                    arrays = [_as_program_dtype(k, a, server.input_dtypes[k])
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
    `device` (None = the card). `predict` serves (frames, c3d) -> maps;
    `fused` and `fused_int8` (the int8 tower) serve (video,) -> maps,
    video [F,H,W,3] pixels in the program's video dtype (a uint8 bundle's
    stay uint8 through the batcher and the copy to the card). The batcher
    pads each coalesced batch to a power-of-two bucket."""
    if program != "predict" and program not in _VIDEO_PROGRAMS:
        raise ValueError(
            f"program must be predict|fused|fused_int8, got {program}")
    manifest = read_manifest(bundle_dir)
    meta = program_meta(manifest, program)
    if program in _VIDEO_PROGRAMS and not meta:
        raise ValueError(f"bundle has no {program!r} program (saved without "
                         f"{_VIDEO_PROGRAMS[program][1]}/num_frames)")
    model = load_bundle(bundle_dir, device=device)
    if program in _VIDEO_PROGRAMS:
        predict = _VIDEO_PROGRAMS[program][0](model)
        hw = tuple(meta.get("video_hw") or (None, None))
        return GazeServer(
            lambda video: predict(video).cpu().numpy(), ("video",),
            host=host, port=port, max_batch=max_batch,
            max_wait_ms=max_wait_ms, input_ndims={"video": 4},
            input_shapes={"video": (meta["num_frames"], *hw, 3)},
            input_dtypes={"video": meta.get("video_dtype", "float32")})
    cfg = model.cfg
    dev = next(model.parameters()).device
    wire = WIRE_DTYPES[meta.get("wire_dtype", "float32")]
    t = meta.get("t", cfg.n_lstm_steps)

    def on_card(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev).to(wire).float()

    def predict_fn(frames: np.ndarray, c3d: np.ndarray) -> np.ndarray:
        # each stream goes up only for a model that reads it (frames:
        # gaze_framewise_shallownet alone, which reads no features)
        frames_in = (on_card(frames) if model.reads_frames
                     else torch.from_numpy(frames))
        feats = on_card(c3d) if model.reads_c3d else torch.from_numpy(c3d)
        return model.predict(frames_in, feats).cpu().numpy()

    return GazeServer(
        predict_fn, ("frames", "c3d"), host=host, port=port,
        max_batch=max_batch, max_wait_ms=max_wait_ms,
        input_ndims={"frames": 4, "c3d": 4},
        input_shapes={"frames": (t, cfg.image_height, cfg.image_width, 3),
                      "c3d": (t, cfg.dim_feature, 7, 7)})
