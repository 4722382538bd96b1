"""Leveled logging for lightgbm_tpu_torch.

Counterpart of the reference logger (include/LightGBM/utils/log.h:22-105):
Debug/Info/Warning levels plus a Fatal that raises instead of aborting
the process. Level, callback, run context and sinks are read and written
under a module lock. While a RunRecorder is active (obs/recorder.py) it
installs a *run context* provider and every line gains a ``[t+12.3s
it=140]`` prefix (run elapsed seconds and current boosting iteration);
tee sinks (``add_sink``; the flight recorder's log ring, obs/flight.py)
see every emitted line without re-routing the output.
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
# zero-arg provider -> (run_elapsed_seconds, iteration-or-None) | None;
# installed by an active RunRecorder, cleared at finish
_run_context = None
# additive tee sinks: each receives every emitted line (after the level
# filter, with the run prefix); a sink must be cheap and never raise
_sinks: list = []


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


def set_run_context(provider) -> None:
    """Install (or clear, with None) the run-prefix provider."""
    global _run_context
    with _lock:
        _run_context = provider


def add_sink(fn) -> None:
    """Register a tee sink fed every emitted line (idempotent)."""
    with _lock:
        if fn not in _sinks:
            _sinks.append(fn)


def remove_sink(fn) -> None:
    with _lock:
        if fn in _sinks:
            _sinks.remove(fn)


def _write(level: LogLevel, tag: str, msg: str) -> None:
    with _lock:
        lvl, cb, ctx = _current_level, _callback, _run_context
        sinks = tuple(_sinks)
    if level > lvl:
        return
    prefix = ""
    if ctx is not None:
        try:
            rc = ctx()
        except Exception:               # noqa: BLE001 — the prefix is
            rc = None                   # decoration, never a failure
        if rc is not None:
            elapsed, it = rc
            prefix = ("[" + f"t+{elapsed:.1f}s"
                      + (f" it={it}" if it is not None else "") + "] ")
    line = f"[LightGBM-TPU] [{tag}] {prefix}{msg}"
    for sink in sinks:
        try:
            sink(line)
        except Exception:               # noqa: BLE001 — a sink must
            pass                        # never break the logged path
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
