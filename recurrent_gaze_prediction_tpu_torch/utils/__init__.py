from .logging import log, mkdir_p
from .platform import resolve_device, tf32_off
from .tree import cast_floating, describe, param_bytes, param_count

__all__ = ["log", "mkdir_p", "resolve_device", "tf32_off", "param_count",
           "param_bytes", "cast_floating", "describe"]
