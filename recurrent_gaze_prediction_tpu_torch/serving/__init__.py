"""Serving: bundles, micro-batching, HTTP server."""

from .batcher import DynamicBatcher
from .bundle import load_bundle, read_manifest, save_bundle
from .server import GazeServer, server_from_bundle

__all__ = ["DynamicBatcher", "GazeServer", "server_from_bundle",
           "save_bundle", "load_bundle", "read_manifest"]
