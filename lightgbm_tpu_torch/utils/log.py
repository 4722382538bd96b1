"""Leveled logging for lightgbm_tpu_torch.

Counterpart of the reference logger (include/LightGBM/utils/log.h:22-105):
Debug/Info/Warning levels plus a Fatal that raises instead of aborting
the process. Level and callback are read and written under a module lock.
"""
from __future__ import annotations

import sys
import threading
from enum import IntEnum


class LogLevel(IntEnum):
    FATAL = -1
    WARNING = 0
    INFO = 1
    DEBUG = 2


class LightGBMError(RuntimeError):
    """Raised where the reference calls Log::Fatal (utils/log.h:83)."""


_lock = threading.Lock()
_current_level = LogLevel.INFO
_callback = None


def set_level(level: LogLevel | int) -> None:
    global _current_level
    with _lock:
        _current_level = LogLevel(int(level))


def get_level() -> LogLevel:
    with _lock:
        return _current_level


def set_callback(cb) -> None:
    """Redirect log output (mirrors Log::ResetCallBack)."""
    global _callback
    with _lock:
        _callback = cb


def _write(level: LogLevel, tag: str, msg: str) -> None:
    with _lock:
        lvl, cb = _current_level, _callback
    if level > lvl:
        return
    line = f"[LightGBM-TPU] [{tag}] {msg}"
    if cb is not None:
        cb(line + "\n")
    else:
        print(line, file=sys.stderr, flush=True)


def debug(msg: str, *args) -> None:
    _write(LogLevel.DEBUG, "Debug", msg % args if args else msg)


def info(msg: str, *args) -> None:
    _write(LogLevel.INFO, "Info", msg % args if args else msg)


def warning(msg: str, *args) -> None:
    _write(LogLevel.WARNING, "Warning", msg % args if args else msg)


def fatal(msg: str, *args) -> None:
    raise LightGBMError(msg % args if args else msg)


def check(condition: bool, msg: str = "Check failed") -> None:
    """CHECK macro equivalent (utils/log.h:22)."""
    if not condition:
        fatal(msg)
