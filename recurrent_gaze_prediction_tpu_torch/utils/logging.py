"""Console logger with a custom INFOV ("info, verbose/highlight") level.

The port's copy of the JAX package's `utils/logging.py`, cut to what the
server and the CLI use: `log.info/infov/warn` on top of stdlib logging,
with ANSI colors when stderr is a terminal.
"""

from __future__ import annotations

import logging
import os
import sys

INFOV = logging.INFO + 1

_COLORS = {
    logging.INFO: "\033[0m",       # default
    INFOV: "\033[32;1m",           # bold green
    logging.WARNING: "\033[33m",   # yellow
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def __init__(self, use_color: bool):
        super().__init__(fmt="%(asctime)s %(levelname)-7s %(message)s",
                         datefmt="%H:%M:%S")
        self._use_color = use_color

    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        if self._use_color:
            return f"{_COLORS.get(record.levelno, '')}{msg}{_RESET}"
        return msg


class _Log:
    """Tiny facade with the reference's `log` object interface."""

    def __init__(self, name: str = "rgp_torch"):
        logging.addLevelName(INFOV, "INFOV")
        self._logger = logging.getLogger(name)
        if not self._logger.handlers:
            handler = logging.StreamHandler(sys.stderr)
            use_color = (sys.stderr.isatty()
                         and os.environ.get("NO_COLOR") is None)
            handler.setFormatter(_ColorFormatter(use_color))
            self._logger.addHandler(handler)
            self._logger.setLevel(logging.INFO)
            self._logger.propagate = False

    def info(self, msg, *args) -> None:
        self._logger.info(msg, *args)

    def infov(self, msg, *args) -> None:
        self._logger.log(INFOV, msg, *args)

    def warn(self, msg, *args) -> None:
        self._logger.warning(msg, *args)


log = _Log()
