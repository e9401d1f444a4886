from .logging import log, mkdir_p
from .platform import resolve_device, tf32_off

__all__ = ["log", "mkdir_p", "resolve_device", "tf32_off"]
