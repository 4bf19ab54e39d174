"""Leveled print-logger with mirrored log files.

Copy of npcd_tpu/utils/logging.py (which imports no JAX), a rebuild of
the reference logger (npcd/utils/logging.py:28-84):
a process-global logger that prints to stdout and mirrors every line into
N registered log files.
"""
from __future__ import annotations

import datetime
import os
import sys
from typing import List

_LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40}

_level = _LEVELS["info"]
_log_files: List[str] = []


def set_level(level: str) -> None:
    global _level
    _level = _LEVELS[level.lower()]


def add_log_file(path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if path not in _log_files:
        _log_files.append(path)


def remove_log_file(path: str) -> None:
    if path in _log_files:
        _log_files.remove(path)


def _emit(level: str, msg: str) -> None:
    if _LEVELS[level] < _level:
        return
    stamp = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
    line = f"[{stamp}] [{level.upper():7s}] {msg}" if msg else ""
    print(line, file=sys.stderr if level == "error" else sys.stdout)
    for path in _log_files:
        try:
            with open(path, "a") as f:
                f.write(line + "\n")
        except OSError:  # pragma: no cover - log mirroring is best-effort
            pass


def debug(msg: str = "") -> None:
    _emit("debug", str(msg))


def info(msg: str = "") -> None:
    _emit("info", str(msg))


def warning(msg: str = "") -> None:
    _emit("warning", str(msg))


def error(msg: str = "") -> None:
    _emit("error", str(msg))
