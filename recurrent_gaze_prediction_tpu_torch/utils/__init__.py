from .logging import log
from .platform import resolve_device

__all__ = ["log", "resolve_device"]
