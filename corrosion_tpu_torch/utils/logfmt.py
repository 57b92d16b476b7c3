"""Process log formatting — plaintext or JSON lines.

The reference selects its tracing-subscriber format from config
(LogFormat, corro-types/src/config.rs:318-326; wired in
corrosion/src/main.rs): human-readable plaintext (optionally colored) or
one JSON object per line for log shippers. Same selection here for the
stdlib logging stack the agent uses.
"""

from __future__ import annotations

import json
import logging
import sys
import time

_COLORS = {
    "DEBUG": "\x1b[36m",
    "INFO": "\x1b[32m",
    "WARNING": "\x1b[33m",
    "ERROR": "\x1b[31m",
    "CRITICAL": "\x1b[35m",
}
_RESET = "\x1b[0m"


class JsonFormatter(logging.Formatter):
    """One JSON object per line: ts/level/target/msg (+ exception)."""

    def format(self, record: logging.LogRecord) -> str:
        obj = {
            "ts": time.strftime(
                "%Y-%m-%dT%H:%M:%S", time.gmtime(record.created)
            )
            + f".{int(record.msecs):03d}Z",
            "level": record.levelname,
            "target": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info and record.exc_info[0] is not None:
            obj["exception"] = self.formatException(record.exc_info)
        return json.dumps(obj, separators=(",", ":"))


class PlainFormatter(logging.Formatter):
    def __init__(self, colors: bool = False) -> None:
        super().__init__(
            "%(asctime)s %(levelname)s %(name)s: %(message)s",
            "%Y-%m-%dT%H:%M:%S",
        )
        self._colors = colors

    def format(self, record: logging.LogRecord) -> str:
        out = super().format(record)
        if self._colors:
            col = _COLORS.get(record.levelname)
            if col:
                out = col + out + _RESET
        return out


def setup_logging(fmt: str = "plaintext", colors: bool = False,
                  level: int = logging.INFO) -> None:
    """Install the selected formatter on the root logger (idempotent:
    replaces handlers this function installed before)."""
    root = logging.getLogger()
    root.setLevel(level)
    for h in list(root.handlers):
        if getattr(h, "_corro_log", False):
            root.removeHandler(h)
    handler = logging.StreamHandler(sys.stderr)
    handler._corro_log = True
    if fmt == "json":
        handler.setFormatter(JsonFormatter())
    else:
        use_colors = colors and sys.stderr.isatty()
        handler.setFormatter(PlainFormatter(colors=use_colors))
    root.addHandler(handler)
