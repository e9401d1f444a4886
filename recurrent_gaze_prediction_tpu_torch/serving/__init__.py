"""Serving: bundles and their stream program, micro-batching, HTTP
server."""

from .batcher import DynamicBatcher
from .bundle import (initial_stream_state, load_bundle, read_manifest,
                     save_bundle, stream_step)
from .server import GazeServer, server_from_bundle

__all__ = ["DynamicBatcher", "GazeServer", "server_from_bundle",
           "save_bundle", "load_bundle", "read_manifest", "stream_step",
           "initial_stream_state"]
