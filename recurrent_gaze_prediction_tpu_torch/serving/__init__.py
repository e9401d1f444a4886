"""Serving: bundles and their stream and fused programs, the fused
programs' staged video upload, micro-batching, HTTP server."""

from .batcher import DynamicBatcher
from .bundle import (fused_int8_predict_fn, fused_predict_fn,
                     initial_stream_state, load_bundle, read_manifest,
                     save_bundle, stream_step)
from .server import GazeServer, server_from_bundle

__all__ = ["DynamicBatcher", "GazeServer", "server_from_bundle",
           "save_bundle", "load_bundle", "read_manifest", "stream_step",
           "initial_stream_state", "fused_predict_fn",
           "fused_int8_predict_fn"]
