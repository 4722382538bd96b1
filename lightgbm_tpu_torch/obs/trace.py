"""Cross-thread span tracing: a ring-buffered Chrome trace-event
recorder.

The JAX package's ``obs/trace.py``. One trace file shows what every
thread of the LRB loop (lrb.py) was doing on a shared clock: the main
thread's OPT labels and feature derivation, the trainer thread's window
training and model swap, and the server thread's evaluation requests.

Output is the Chrome trace-event JSON format (the ``traceEvents``
array form), loadable in Perfetto (ui.perfetto.dev) and chrome://
tracing:

- spans are complete events (``ph == "X"``: ``ts``/``dur`` in
  microseconds, ``pid``/``tid`` integers);
- point-in-time markers (model swaps) are instant events
  (``ph == "i"``, thread scope);
- thread names are emitted as ``ph == "M"`` metadata records so
  Perfetto labels the trainer row "lrb-trainer_0" instead of a bare
  thread id.

Design constraints (the registry's rules, obs/registry.py):

- **Thread-safe.** Spans are recorded from the main, trainer and server
  threads concurrently; every mutation takes one lock. Events are
  appended at span EXIT (complete events carry their duration), so a
  span records with a single locked append.
- **Bounded.** The buffer is a ring (``tpu_trace_buffer`` events): a
  long serving loop keeps the LAST N events instead of growing without
  bound; ``dropped_events`` counts what the ring evicted (surfaced in
  the written file's metadata).
- **Dependency-free.** Standard library only.
- **Off is free.** With no tracer installed (``tpu_trace`` unset, the
  default) every record call is a module-attribute read and a no-op.

The module-global tracer is installed by ``configure`` (the LRB driver
calls ``ensure_from_config`` with its params) and the buffer is flushed
to disk by ``write()``: after every LRB window (so a live loop always
has a current trace on disk), and at interpreter exit as a safety net.
Every event also reaches the registered sinks (``add_sink``), with or
without a tracer installed: the flight recorder's span ring
(obs/flight.py) keeps span evidence even when ``tpu_trace`` is off.
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Optional

from ..analysis import lockorder
from ..utils.fileio import atomic_write
from . import identity

__all__ = [
    "Tracer", "configure", "ensure_from_config", "stop", "active",
    "enabled", "span", "instant", "write", "config_get",
    "add_sink", "remove_sink",
]


def config_get(config, key: str, default=None):
    """Read a knob off a Config object (attribute) or a raw params
    dict (key): the one accessor behind the ``ensure_from_config``
    seams (this module, obs/reqlog.py, obs/export.py and obs/flight.py).
    Returns ``default`` for missing OR explicitly-None values."""
    if isinstance(config, dict):
        v = config.get(key, default)
    else:
        v = getattr(config, key, default)
    return default if v is None else v

DEFAULT_BUFFER_EVENTS = 65536
MIN_BUFFER_EVENTS = 1024

# event sinks: callables fed EVERY recorded event dict, tracer or not
# (the flight recorder's always-on span ring, obs/flight.py). Fed
# outside the tracer's lock; a sink must be cheap and never raise.
_sinks: list = []
# fallback clock for sink-only events (no tracer installed): same
# perf_counter µs convention as Tracer.now_us, epoch at module import
_sink_t0_ns = time.perf_counter_ns()


def add_sink(fn) -> None:
    """Register an event sink (idempotent — re-registration of the
    same callable is a no-op)."""
    if fn not in _sinks:
        _sinks.append(fn)


def remove_sink(fn) -> None:
    if fn in _sinks:
        _sinks.remove(fn)


def sink_clock() -> Optional[float]:
    """The sinks' clock (µs) when sinks are registered and no tracer is
    installed, else None: the start of a span that ``sink_span`` ends
    (utils/timing.py's phases reach the flight ring this way)."""
    if _tracer is not None or not _sinks:
        return None
    return _sink_now_us()


def sink_span(name: str, cat: str, t0_us: float,
              args: Optional[dict] = None) -> None:
    """End a span started at ``sink_clock()``: the sinks get it."""
    _sink_only_event(name, cat, "X", t0_us, dur_us=_sink_now_us() - t0_us,
                     args=args)


def _feed_sinks(ev: dict) -> None:
    for s in tuple(_sinks):
        try:
            s(ev)
        except Exception:               # noqa: BLE001 — a sink must
            pass                        # never break the traced path


def _sink_only_event(name: str, cat: str, ph: str, ts_us: float,
                     dur_us: Optional[float] = None,
                     args: Optional[dict] = None) -> None:
    """Record an event for the sinks when NO tracer is installed (the
    flight ring keeps span evidence even with tpu_trace off)."""
    ev = {"name": name, "cat": cat, "ph": ph, "ts": round(ts_us, 3),
          "pid": os.getpid(), "tid": _native_tid()}
    if ph == "X":
        ev["dur"] = round(max(dur_us or 0.0, 0.0), 3)
    elif ph == "i":
        ev["s"] = "t"
    if args:
        ev["args"] = args
    _stamp_rank(ev)
    _feed_sinks(ev)


def _stamp_rank(ev: dict) -> None:
    """Rank (and, once past the first re-shard, incarnation) into the
    event args under a multi-process world — per-event identity so a
    merged timeline attributes every span without filename context.
    Free single-process."""
    if not identity.is_multiprocess():
        return
    args = ev.setdefault("args", {})
    args.setdefault("rank", identity.rank())
    inc = identity.incarnation()
    if inc:
        args.setdefault("inc", inc)


def _sink_now_us() -> float:
    return (time.perf_counter_ns() - _sink_t0_ns) / 1000.0


def _native_tid() -> int:
    try:
        return threading.get_native_id()
    except Exception:                   # noqa: BLE001 — pre-3.8 fallback
        return threading.get_ident() & 0x7FFFFFFF


class Tracer:
    """Ring-buffered trace-event recorder; one per process normally
    (the module global), private instances for tests."""

    def __init__(self, path: str, capacity: int = DEFAULT_BUFFER_EVENTS):
        self.path = str(path)
        self.capacity = max(int(capacity), MIN_BUFFER_EVENTS)
        self._lock = lockorder.named_lock("obs.trace._lock")
        self._events: deque = deque(maxlen=self.capacity)
        self._threads: dict = {}        # tid -> thread name
        self._dropped = 0
        self._pid = os.getpid()
        self._t0_ns = time.perf_counter_ns()
        self._started_unix = time.time()

    def resize(self, capacity: int) -> None:
        """Change the ring capacity in place, keeping the newest
        events (a later config naming the same trace path but a larger
        tpu_trace_buffer must not be silently ignored)."""
        capacity = max(int(capacity), MIN_BUFFER_EVENTS)
        with self._lock:
            if capacity == self.capacity:
                return
            self.capacity = capacity
            self._events = deque(self._events, maxlen=capacity)

    # -- clock ---------------------------------------------------------------

    def now_us(self) -> float:
        """Microseconds since tracer start — the shared ``ts`` clock
        (perf_counter is monotonic and thread-consistent)."""
        return (time.perf_counter_ns() - self._t0_ns) / 1000.0

    # -- recording -----------------------------------------------------------

    def _append(self, ev: dict) -> None:
        _stamp_rank(ev)
        with self._lock:
            if len(self._events) == self.capacity:
                self._dropped += 1
            self._events.append(ev)
        _feed_sinks(ev)                 # outside the ring lock

    def _register_thread(self, tid: int) -> None:
        if tid not in self._threads:
            name = threading.current_thread().name
            with self._lock:
                self._threads.setdefault(tid, name)

    def complete(self, name: str, cat: str, start_us: float,
                 args: Optional[dict] = None) -> None:
        """Record a finished span [start_us, now] on the CALLING
        thread (complete events pair begin/end in one record, so
        cross-thread spans can never mis-nest)."""
        tid = _native_tid()
        self._register_thread(tid)
        end = self.now_us()
        ev = {"name": name, "cat": cat, "ph": "X",
              "ts": round(start_us, 3),
              "dur": round(max(end - start_us, 0.0), 3),
              "pid": self._pid, "tid": tid}
        if args:
            ev["args"] = args
        self._append(ev)

    def instant(self, name: str, cat: str = "event",
                args: Optional[dict] = None) -> None:
        """Record a point-in-time marker on the calling thread."""
        tid = _native_tid()
        self._register_thread(tid)
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
              "ts": round(self.now_us(), 3),
              "pid": self._pid, "tid": tid}
        if args:
            ev["args"] = args
        self._append(ev)

    @contextmanager
    def span(self, name: str, cat: str = "phase",
             args: Optional[dict] = None):
        t0 = self.now_us()
        try:
            yield
        finally:
            self.complete(name, cat, t0, args)

    # -- stats / serialization ----------------------------------------------

    @property
    def dropped_events(self) -> int:
        with self._lock:
            return self._dropped

    def event_count(self) -> int:
        with self._lock:
            return len(self._events)

    def trace_document(self) -> dict:
        """The Perfetto-loadable JSON document for the current buffer:
        thread-name metadata records first, then the ring's events."""
        with self._lock:
            events = list(self._events)
            threads = dict(self._threads)
            dropped = self._dropped
        ident = identity.identity()
        pname = "lightgbm_tpu_torch"
        if ident["world"] > 1:
            pname = f"lightgbm_tpu_torch r{ident['machine_rank']}"
        meta = [{"name": "process_name", "ph": "M", "pid": self._pid,
                 "tid": 0, "args": {"name": pname}},
                # the full identity record as process metadata, so a
                # merged multi-rank file keeps each process labeled
                {"name": "process_labels", "ph": "M", "pid": self._pid,
                 "tid": 0, "args": {"labels": (
                     f"rank {ident['machine_rank']}/{ident['world']} "
                     f"inc {ident['incarnation']}")}}]
        for tid, tname in sorted(threads.items()):
            meta.append({"name": "thread_name", "ph": "M",
                         "pid": self._pid, "tid": tid,
                         "args": {"name": tname}})
        return {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {
                "schema": "lightgbm-tpu/trace",
                "version": 1,
                "started_unix": round(self._started_unix, 3),
                "dropped_events": dropped,
                "identity": ident,
            },
        }

    def write(self) -> str:
        """Dump the current buffer to ``path`` (atomic tmp+rename,
        utils/fileio.py). Idempotent —
        callable after every window of a live loop; each write
        replaces the file with the ring's current contents."""
        doc = self.trace_document()
        with atomic_write(self.path) as fh:
            json.dump(doc, fh)
        return self.path


# ---------------------------------------------------------------------------
# module-global tracer (the port's default; tests build private ones)
# ---------------------------------------------------------------------------

_tracer: Optional[Tracer] = None
_atexit_installed = False


def configure(path: str, capacity: int = DEFAULT_BUFFER_EVENTS) -> Tracer:
    """Install (or re-target) the process-global tracer. Idempotent for
    the same path — the running buffer is kept so early spans survive.
    Re-targeting to a NEW
    path flushes the old tracer's buffer to its own file first, so
    spans recorded after its last write are not silently dropped."""
    global _tracer, _atexit_installed
    if _tracer is not None and _tracer.path == str(path):
        # honor a LARGER buffer knob on same-path reconfigure; never
        # shrink mid-run (a later caller with the default capacity —
        # e.g. a params dict without tpu_trace_buffer — must not drop
        # the events an earlier explicit knob sized the ring for)
        if capacity > _tracer.capacity:
            _tracer.resize(capacity)
        return _tracer
    if _tracer is not None:
        write()                 # never-raises flush of the old buffer
    _tracer = Tracer(path, capacity)
    if not _atexit_installed:
        # safety net: a crashed/interrupted run still leaves a trace
        atexit.register(write)
        _atexit_installed = True
    return _tracer


def ensure_from_config(config) -> Optional[Tracer]:
    """Install the global tracer when ``tpu_trace`` is set on a Config
    (attribute) or params dict (key); the LRB driver calls it at
    construction."""
    path = str(config_get(config, "tpu_trace", "") or "")
    if not path:
        return None
    # one trace file per rank (obs/identity.py): world>1 must never
    # atomic-replace a peer's buffer with its own
    path = identity.rank_suffixed(path)
    cap = int(config_get(config, "tpu_trace_buffer",
                         DEFAULT_BUFFER_EVENTS) or DEFAULT_BUFFER_EVENTS)
    return configure(path, cap)


def stop() -> None:
    """Uninstall the global tracer (tests) without writing."""
    global _tracer
    _tracer = None


def active() -> Optional[Tracer]:
    return _tracer


def enabled() -> bool:
    return _tracer is not None


@contextmanager
def span(name: str, cat: str = "phase", args: Optional[dict] = None):
    """Record a span on the global tracer; free no-op when tracing is
    off. With no tracer but registered sinks (the always-on flight ring), the event
    still reaches the sinks — the black box keeps span evidence even
    when ``tpu_trace`` is off."""
    tr = _tracer
    if tr is None:
        if not _sinks:
            yield
            return
        t0 = _sink_now_us()
        try:
            yield
        finally:
            _sink_only_event(name, cat, "X", t0,
                             dur_us=_sink_now_us() - t0, args=args)
        return
    t0 = tr.now_us()
    try:
        yield
    finally:
        tr.complete(name, cat, t0, args)


def instant(name: str, cat: str = "event",
            args: Optional[dict] = None) -> None:
    tr = _tracer
    if tr is not None:
        tr.instant(name, cat, args)
    elif _sinks:
        _sink_only_event(name, cat, "i", _sink_now_us(), args=args)


_write_warned = False


def write() -> Optional[str]:
    """Flush the global tracer's buffer to its path; None when off.
    Never raises — tracing is an observability aid, not a failure
    mode (the atexit hook runs this) — but the FIRST failure logs a
    warning so an unwritable tpu_trace path is not a silent no-trace
    run (the run-report 'could not write' pattern)."""
    global _write_warned
    tr = _tracer
    if tr is None:
        return None
    try:
        return tr.write()
    except OSError as e:
        if not _write_warned:
            _write_warned = True
            try:
                from ..utils import log
                log.warning("could not write trace %s: %s", tr.path, e)
            except Exception:       # noqa: BLE001 — atexit teardown
                pass
        return None
