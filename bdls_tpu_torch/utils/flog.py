"""Leveled logging with a runtime-mutable per-logger level spec.

Reference parity: ``common/flogging`` — a global registry of named
loggers, level spec strings of the form ``logger1,logger2=debug:warning``
(default level after the last colonless segment), runtime-mutable via the
operations server's ``/logspec`` endpoint, and an observer hook counting
error lines (flogging/metrics).

The port's copy of ``bdls_tpu/utils/flog.py``, unchanged: the registry
behind the operations endpoint's ``/logspec``.
"""

from __future__ import annotations

import logging
import sys
import threading
from typing import Callable, Optional

_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
    "panic": logging.CRITICAL,
}
_LEVEL_NAMES = {v: k for k, v in _LEVELS.items() if k != "warn"}


class LogRegistry:
    def __init__(self, default_level: str = "info", stream=None):
        self._lock = threading.Lock()
        self._spec = default_level
        self._default = _LEVELS[default_level]
        self._overrides: dict[str, int] = {}
        self._loggers: dict[str, logging.Logger] = {}
        self._error_observer: Optional[Callable[[str], None]] = None
        self._handler = logging.StreamHandler(stream or sys.stderr)
        self._handler.setFormatter(
            logging.Formatter(
                "%(asctime)s %(levelname).4s [%(name)s] %(message)s",
                datefmt="%H:%M:%S",
            )
        )

    def get_logger(self, name: str) -> logging.Logger:
        with self._lock:
            if name not in self._loggers:
                lg = logging.getLogger(f"bdls.{name}")
                lg.propagate = False
                if not lg.handlers:
                    lg.addHandler(self._handler)
                if self._error_observer is not None:
                    lg.addFilter(self._make_observer_filter())
                self._loggers[name] = lg
                self._apply_level(name, lg)
            return self._loggers[name]

    def set_error_observer(self, fn: Callable[[str], None]) -> None:
        with self._lock:
            self._error_observer = fn
            for lg in self._loggers.values():
                lg.addFilter(self._make_observer_filter())

    def _make_observer_filter(self):
        observer = self._error_observer

        def _filter(record: logging.LogRecord) -> bool:
            if observer is not None and record.levelno >= logging.ERROR:
                observer(record.name)
            return True

        return _filter

    # ---- level spec ------------------------------------------------------
    def spec(self) -> str:
        with self._lock:
            return self._spec

    def set_spec(self, spec: str) -> None:
        """Parse ``a,b=debug:info``-style spec (last default wins)."""
        default = logging.INFO
        overrides: dict[str, int] = {}
        for seg in spec.split(":"):
            seg = seg.strip()
            if not seg:
                continue
            if "=" in seg:
                names, _, level = seg.rpartition("=")
                lvl = _LEVELS.get(level.lower())
                if lvl is None:
                    raise ValueError(f"invalid log level {level!r}")
                for name in names.split(","):
                    if name:
                        overrides[name.strip()] = lvl
            else:
                lvl = _LEVELS.get(seg.lower())
                if lvl is None:
                    raise ValueError(f"invalid log level {seg!r}")
                default = lvl
        with self._lock:
            self._spec = spec
            self._default = default
            self._overrides = overrides
            for name, lg in self._loggers.items():
                self._apply_level(name, lg)

    def _apply_level(self, name: str, lg: logging.Logger) -> None:
        level = self._default
        best = -1
        for prefix, lvl in self._overrides.items():
            if (name == prefix or name.startswith(prefix + ".")) and len(
                prefix
            ) > best:
                best = len(prefix)
                level = lvl
        lg.setLevel(level)


GLOBAL = LogRegistry()


def get_logger(name: str) -> logging.Logger:
    return GLOBAL.get_logger(name)
