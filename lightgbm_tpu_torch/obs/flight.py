"""Flight recorder: an always-on black box that dumps a postmortem
bundle at the moment something goes wrong.

The JAX package's ``obs/flight.py``. When a window degrades, the
watchdog fires, a fault injects, an SLO budget burns dry, or the process
is torn down, the evidence an operator needs is scattered across the
trace ring, the exporter's snapshots, the log tail and the request log,
with nothing tying them to the failure instant. This module keeps a
bounded in-memory ring of ALL of them, all the time (capacity
``tpu_flight_buffer``; 0 disables), and on a trigger writes ONE
self-contained JSON bundle (schema ``lightgbm-tpu/flight`` v1, the JAX
package's, so one reader serves both; atomic write):

- the newest span/instant events (fed by a trace sink, obs/trace.py,
  recorded even when no ``tpu_trace`` tracer is installed);
- the newest log lines (a tee sink on utils/log.py);
- the newest request-log wide events (obs/reqlog.py ring);
- the exporter's recent metric snapshots (obs/export.py) plus a fresh
  full registry snapshot at dump time;
- the SLO engine's last budget report (obs/slo.py);
- the trigger history (every trigger is recorded even when its dump
  was rate-limited).

Triggers: watchdog firings (obs/recorder.py), fault injection
(utils/faults.py: the dump lands BEFORE a ``kill`` action SIGKILLs the
process), degraded LRB windows (lrb.py), SLO budget exhaustion
(obs/slo.py), SIGTERM, uncaught exceptions (sys.excepthook chain), and
an atexit sweep that persists a pending rate-limited trigger. Dumps are
rate-limited (``MIN_DUMP_INTERVAL_S`` apart, ``MAX_DUMPS`` per process;
``force`` bypasses both for the moments that cannot recur: SIGTERM,
kill-action faults, budget exhaustion) and cross-linked from run
reports as ``meta.flight_dumps`` (obs/recorder.py) and from the LRB
driver's ``flight_dumps``.

Dump directory: ``tpu_flight_dir``, else the first configured artifact
path's directory (``tpu_run_report`` / ``tpu_reqlog`` /
``tpu_metrics_export`` / ``tpu_trace``), else the system temp dir: a
bare run never litters the working directory. The JAX package's
incident sweep over many ranks' bundles (its ``obs/incident.py``) is
ROADMAP item 19. Standard library only.
"""
from __future__ import annotations

import atexit
import json
import os
import re
import signal
import sys
import tempfile
import threading
import time
from collections import deque
from typing import List, Optional

from ..analysis import lockorder
from ..utils import log
from ..utils.fileio import atomic_write
from . import identity
from . import trace as _trace
from .registry import MetricsRegistry, default_registry
from .trace import config_get

__all__ = [
    "FlightRecorder", "configure", "ensure_from_config", "get",
    "active", "trigger", "dump_paths", "shutdown",
    "FLIGHT_SCHEMA", "FLIGHT_VERSION",
]

FLIGHT_SCHEMA = "lightgbm-tpu/flight"
FLIGHT_VERSION = 1

DEFAULT_BUFFER = 256          # spans / log lines / reqlog records kept
METRIC_SNAPS_KEPT = 6         # exporter-interval snapshots kept
MIN_DUMP_INTERVAL_S = 2.0     # non-forced triggers this close coalesce
MAX_DUMPS = 16                # per-process dump cap (runaway guard)
_TRIGGERS_KEPT = 64

_REASON_RE = re.compile(r"[^A-Za-z0-9_.-]")


class FlightRecorder:
    """The bounded black box + its dump machinery. One per process
    normally (the module global); private instances for tests."""

    def __init__(self, capacity: int = DEFAULT_BUFFER,
                 directory: str = "",
                 registry: Optional[MetricsRegistry] = None,
                 min_dump_interval_s: float = MIN_DUMP_INTERVAL_S,
                 max_dumps: int = MAX_DUMPS):
        self.capacity = max(int(capacity), 16)
        self.directory = directory or tempfile.gettempdir()
        self.min_dump_interval_s = float(min_dump_interval_s)
        self.max_dumps = int(max_dumps)
        self._reg = registry or default_registry()
        # REENTRANT: the SIGTERM handler runs trigger() on whatever
        # the main thread was doing — including mid-trigger with this
        # lock held; a plain Lock would deadlock the dying process
        self._lock = lockorder.named_rlock("obs.flight._lock")
        self._spans: deque = deque(maxlen=self.capacity)
        self._logs: deque = deque(maxlen=self.capacity)
        self._metric_snaps: deque = deque(maxlen=METRIC_SNAPS_KEPT)
        self._triggers: deque = deque(maxlen=_TRIGGERS_KEPT)
        self._dump_paths: List[str] = []
        self._last_dump_t: Optional[float] = None
        self._pending: Optional[tuple] = None   # rate-limited trigger
        self._seq = 0
        self._write_warned = False

    # -- feeds (each a lock-free deque append: hot-path safe) ----------------

    def note_span(self, ev: dict) -> None:
        """Trace sink: every recorded span/instant event lands here
        too (obs/trace.py add_sink)."""
        self._spans.append(ev)

    def note_log(self, line: str) -> None:
        """Log sink: every emitted log line (utils/log.py add_sink)."""
        self._logs.append(line.rstrip("\n"))

    def note_metrics(self, snap: dict) -> None:
        """Exporter feed: keep the counters/gauges of the last few
        interval snapshots (the recent time series, compact — the
        full registry state is snapshotted fresh at dump time)."""
        self._metric_snaps.append({
            "ts": snap.get("ts"), "uptime_s": snap.get("uptime_s"),
            "counters": snap.get("counters", {}),
            "gauges": snap.get("gauges", {})})

    # -- triggers ------------------------------------------------------------

    def trigger(self, reason: str, context: Optional[dict] = None,
                force: bool = False) -> Optional[str]:
        """Record a trigger and dump the bundle unless rate-limited.
        -> the dump path, or None when the dump was coalesced (the
        trigger itself is still recorded and swept at exit)."""
        now = time.monotonic()
        rec = {"ts": round(time.time(), 3), "reason": str(reason)}
        if context:
            rec["context"] = context
        with self._lock:
            self._triggers.append(rec)
            capped = len(self._dump_paths) >= self.max_dumps
            limited = (self._last_dump_t is not None
                       and now - self._last_dump_t
                       < self.min_dump_interval_s)
            # ``force`` marks the moments that cannot recur (SIGTERM,
            # kill-action faults, budget exhaustion): they bypass the
            # interval AND the runaway cap — a capped process must
            # still leave the bundle that explains its death
            if (capped or limited) and not force:
                self._pending = (reason, context)
                suppress = True
            else:
                self._last_dump_t = now
                suppress = False
        self._reg.counter("flight/triggers").add(1)
        if suppress:
            self._reg.counter("flight/dumps_suppressed").add(1)
            return None
        return self.dump(reason, context)

    # -- the bundle ----------------------------------------------------------

    def document(self, reason: str,
                 context: Optional[dict] = None) -> dict:
        """The self-contained postmortem document (dump() writes it)."""
        slo_report = None
        try:
            from . import slo as _slo
            eng = _slo.global_engine()
            if eng is not None:
                # the non-reentrant read: evaluate() could itself
                # trigger (budget exhaustion) and recurse into a dump
                slo_report = eng.report(fresh=False)
        except Exception:               # noqa: BLE001 — best effort
            pass
        reqlog_recent: list = []
        try:
            from . import reqlog as _reqlog
            rl = _reqlog.get(create=False)
            if rl is not None:
                reqlog_recent = rl.recent(self.capacity)
        except Exception:               # noqa: BLE001 — best effort
            pass
        with self._lock:
            spans = list(self._spans)
            logs = list(self._logs)
            snaps = list(self._metric_snaps)
            triggers = list(self._triggers)
        return {
            "schema": FLIGHT_SCHEMA,
            "version": FLIGHT_VERSION,
            "created_unix": round(time.time(), 3),
            "pid": os.getpid(),
            "identity": identity.identity(),
            "reason": str(reason),
            "context": context or {},
            "triggers": triggers,
            "spans": spans,
            "log_lines": logs,
            "reqlog": reqlog_recent,
            "metrics": {
                "current": self._reg.snapshot(),
                "recent": snaps,
            },
            "slo": slo_report,
        }

    def dump(self, reason: str,
             context: Optional[dict] = None) -> Optional[str]:
        """Write one bundle (atomic); never raises — the black box
        must not add a failure mode to the failure it records."""
        try:
            doc = self.document(reason, context)
            with self._lock:
                self._seq += 1
                seq = self._seq
                self._pending = None
            # rank segment under world>1: N ranks dumping into one
            # shared directory must never collide on a name
            rtag = (f"r{identity.rank()}_"
                    if identity.is_multiprocess() else "")
            name = (f"flight_{rtag}p{os.getpid()}_{seq:03d}_"
                    f"{_REASON_RE.sub('_', str(reason))[:40]}.json")
            path = os.path.join(self.directory, name)
            with atomic_write(path) as fh:
                json.dump(doc, fh)
            with self._lock:
                self._dump_paths.append(path)
            self._reg.counter("flight/dumps").add(1)
            log.warning("flight recorder: dumped postmortem bundle "
                        "(%s) -> %s", reason, path)
            return path
        except Exception as e:          # noqa: BLE001 — see docstring
            self._reg.counter("flight/dump_failures").add(1)
            if not self._write_warned:
                self._write_warned = True
                try:
                    log.warning("flight recorder could not dump to %s "
                                "(%s)", self.directory, e)
                except Exception:       # noqa: BLE001 — teardown
                    pass
            return None

    def dump_paths(self) -> List[str]:
        with self._lock:
            return list(self._dump_paths)

    def sweep_pending(self) -> Optional[str]:
        """Persist a trigger whose dump was rate-limited (the atexit
        safety net): the last coalesced reason still reaches disk."""
        with self._lock:
            pending = self._pending
            self._pending = None
        if pending is None:
            return None
        return self.dump(pending[0], pending[1])


# ---------------------------------------------------------------------------
# process-global recorder + hook installation
# ---------------------------------------------------------------------------

_global: Optional[FlightRecorder] = None
_global_lock = threading.Lock()
_hooks_installed = False
_sigterm_installed = False
_prev_sigterm = None
_prev_excepthook = None


def _on_sigterm(signum, frame):
    fr = _global
    if fr is not None:
        fr.trigger("sigterm", force=True)
    prev = _prev_sigterm
    if callable(prev):
        prev(signum, frame)
    else:
        # restore the default disposition and re-deliver so the exit
        # status still says "terminated by SIGTERM"
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGTERM)


def _on_uncaught(tp, val, tb):
    fr = _global
    if fr is not None:
        fr.trigger("unhandled_exception",
                   {"type": getattr(tp, "__name__", str(tp)),
                    "message": str(val)[:400]}, force=True)
    hook = _prev_excepthook or sys.__excepthook__
    hook(tp, val, tb)


def _atexit_sweep() -> None:
    fr = _global
    if fr is not None:
        try:
            fr.sweep_pending()
        except Exception:               # noqa: BLE001 — teardown
            pass


def _install_hooks(recorder: FlightRecorder) -> None:
    """Feed sinks + teardown hooks. Sinks/atexit/excepthook install
    once per process and read the CURRENT global recorder, so a test
    swapping in a fresh one (configure) re-routes them without
    re-installing. The SIGTERM handler is tracked SEPARATELY and
    retried: python only allows the install from the main thread, and
    a process whose first booster inits on a worker thread must still
    get its SIGTERM dump armed by a later main-thread init."""
    global _hooks_installed, _sigterm_installed
    global _prev_sigterm, _prev_excepthook
    _trace.add_sink(_sink_span)
    log.add_sink(_sink_log)
    if not _hooks_installed:
        _hooks_installed = True
        atexit.register(_atexit_sweep)
        _prev_excepthook = sys.excepthook
        sys.excepthook = _on_uncaught
    if _sigterm_installed:
        return
    try:
        if threading.current_thread() is threading.main_thread():
            prev = signal.getsignal(signal.SIGTERM)
            if prev != signal.SIG_IGN:
                # a process that deliberately IGNORES SIGTERM keeps
                # ignoring it — the black box must never change
                # whether the host survives a signal, only what
                # evidence a death leaves
                signal.signal(signal.SIGTERM, _on_sigterm)
                _prev_sigterm = prev if callable(prev) else None
            # latched either way: the disposition was SEEN from the
            # main thread (an SIG_IGN choice is honored, not re-polled)
            _sigterm_installed = True
    except (ValueError, OSError):       # exotic env: retry next init
        pass


def _sink_span(ev: dict) -> None:
    fr = _global
    if fr is not None:
        fr.note_span(ev)


def _sink_log(line: str) -> None:
    fr = _global
    if fr is not None:
        fr.note_log(line)


def configure(capacity: int = DEFAULT_BUFFER, directory: str = "",
              min_dump_interval_s: float = MIN_DUMP_INTERVAL_S,
              max_dumps: int = MAX_DUMPS) -> Optional[FlightRecorder]:
    """Install (or replace) the process-global recorder; capacity <= 0
    uninstalls. Tests use this for a fresh, isolated instance."""
    global _global
    with _global_lock:
        if int(capacity) <= 0:
            _global = None
            return None
        _global = FlightRecorder(capacity, directory,
                                 min_dump_interval_s=min_dump_interval_s,
                                 max_dumps=max_dumps)
        _install_hooks(_global)
        return _global


def _dump_dir_from_config(config) -> str:
    """The first configured artifact path names the dump directory —
    postmortems land next to the run's other evidence.
    ``tpu_flight_dir`` overrides: multi-process drivers point every
    rank at ONE shared directory."""
    d = str(config_get(config, "tpu_flight_dir", "") or "")
    if d:
        return d
    for knob in ("tpu_run_report", "tpu_reqlog", "tpu_metrics_export",
                 "tpu_trace"):
        p = str(config_get(config, knob, "") or "")
        if p:
            d = os.path.dirname(p)
            return d or "."
    return ""


def ensure_from_config(config) -> Optional[FlightRecorder]:
    """Start the always-on recorder from ``tpu_flight_buffer`` (every
    driver init calls this; 0 disables). Idempotent: a running
    recorder keeps its ring, honoring only a LARGER capacity (the
    tracer's grow-only rule) and adopting a directory when it is still
    on the temp-dir default."""
    global _global
    cap = int(config_get(config, "tpu_flight_buffer", DEFAULT_BUFFER))
    if cap <= 0:
        return _global          # 0 opts THIS driver out, never tears
        # down a recorder another driver is feeding
    directory = _dump_dir_from_config(config)
    with _global_lock:
        if _global is None:
            _global = FlightRecorder(cap, directory)
            _install_hooks(_global)
            return _global
        if cap > _global.capacity:
            # grow-only resize, keeping the newest entries. Swap in
            # the fresh ring FIRST and then drain the old one via
            # popleft: the sinks append lock-free from other threads,
            # and iterating a deque they are appending to would raise
            # ("deque mutated during iteration") out of a driver init
            _global.capacity = cap
            for attr in ("_spans", "_logs"):
                old = getattr(_global, attr)
                new: deque = deque(maxlen=cap)
                setattr(_global, attr, new)
                # newest-first pop + appendleft keeps original order
                # AND places drained entries before any events the
                # sinks appended to the fresh ring mid-drain
                while True:
                    try:
                        new.appendleft(old.pop())
                    except IndexError:
                        break
        if directory and _global.directory == tempfile.gettempdir():
            _global.directory = directory
        return _global


def get() -> Optional[FlightRecorder]:
    return _global


def active() -> bool:
    return _global is not None


def trigger(reason: str, context: Optional[dict] = None,
            force: bool = False) -> Optional[str]:
    """Trigger the global recorder; no-op (None) when none installed."""
    fr = _global
    if fr is None:
        return None
    return fr.trigger(reason, context, force=force)


def dump_paths() -> List[str]:
    """Paths of every bundle dumped so far this process (run reports
    cross-link these as ``meta.flight_dumps``)."""
    fr = _global
    return fr.dump_paths() if fr is not None else []


def shutdown() -> None:
    """Drop the global recorder (tests); sinks stay installed but
    become no-ops."""
    global _global
    with _global_lock:
        _global = None
