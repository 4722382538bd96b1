"""Live metrics export: a periodic snapshot daemon for the registry.

The JAX package's ``obs/export.py``. The run report (obs/recorder.py) is
batch-shaped: one artifact AFTER training returns. A serving-shaped run
(the LRB loop, lrb.py) needs its telemetry **while it runs**: this
module snapshots the default registry (obs/registry.py) on a fixed
interval from a daemon thread and publishes it three ways:

- ``<base>.prom``: Prometheus text-exposition format, atomically
  replaced every interval (a node_exporter-style textfile);
- ``<base>.jsonl``: an append-only time series, one snapshot per line
  (``{"ts": ..., "counters": ..., "gauges": ..., "phases": ...,
  "histograms": ...}``);
- an optional stdlib ``http.server`` endpoint (``tpu_metrics_port``)
  serving ``GET /metrics`` (Prometheus text), ``GET /metrics.json``
  (the raw snapshot), ``GET /healthz`` (liveness, last-snapshot age and
  the SLO budget state, JSON; 200 even before the first snapshot) and
  ``GET /slo`` (the SLO engine's full budget report, obs/slo.py).

The exporter thread is also the SLO engine's clock: every interval it
evaluates the armed specs (obs/slo.py) BEFORE snapshotting, so the
``slo/*`` budget gauges ride the same Prometheus text and JSONL time
series as everything else, and it feeds each snapshot's counters and
gauges to the flight recorder's recent-metrics ring (obs/flight.py). An
``exporter/last_snapshot_age_s`` gauge makes the exporter's own
staleness observable.

Config knobs: ``tpu_metrics_export`` (the base path; a ``.prom`` /
``.jsonl`` suffix is stripped), ``tpu_metrics_interval_s``,
``tpu_metrics_port`` (0 = no HTTP). Drivers call ``ensure_from_config``:
the exporter is process-global and idempotent, so the LRB loop starts
it once and every later booster joins it. Left out: the JAX package's
rank-0 cluster rollups folded into each snapshot (its
``obs/clusterobs.py``, ROADMAP item 19).

Standard library only, like the registry and tracer.
"""
from __future__ import annotations

import atexit
import json
import re
import threading
import time
from typing import Optional

from ..utils.fileio import atomic_write
from . import identity
from .registry import MetricsRegistry, default_registry
from .trace import config_get

__all__ = [
    "MetricsExporter", "prometheus_text", "ensure_from_config",
    "global_exporter", "shutdown",
]

DEFAULT_INTERVAL_S = 5.0

# Prometheus metric names: [a-zA-Z_:][a-zA-Z0-9_:]*; our registry names
# use "/" domains ("ingest/h2d_bytes") — sanitize + namespace prefix
_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_PREFIX = "lgbm_tpu_"


def _prom_name(name: str) -> str:
    san = _NAME_RE.sub("_", name)
    if not san or not (san[0].isalpha() or san[0] in "_:"):
        san = "_" + san
    return _PREFIX + san


def _fmt(v) -> str:
    if v is None:
        return "NaN"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def prometheus_text(snapshot: dict) -> str:
    """Render a registry snapshot (MetricsRegistry.snapshot()) to the
    Prometheus text-exposition format: counters and gauges one sample
    each, timers as ``_seconds_total``/``_calls_total`` counters plus a
    ``_max_seconds`` gauge, histograms in the native histogram format
    (cumulative ``_bucket{le=...}`` + ``_sum`` + ``_count``)."""
    lines = []

    def emit(name, mtype, value, labels=""):
        lines.append(f"# TYPE {name} {mtype}")
        lines.append(f"{name}{labels} {value}")

    ident = snapshot.get("identity")
    if isinstance(ident, dict):
        # rank identity as an info-style gauge: constant 1, the record
        # in the labels — the Prometheus idiom for build/identity facts
        labels = ",".join(f'{k}="{ident[k]}"' for k in
                          ("machine_rank", "world", "incarnation")
                          if k in ident)
        emit(_PREFIX + "identity_info", "gauge", "1", "{" + labels + "}")
    for name, v in snapshot.get("counters", {}).items():
        emit(_prom_name(name) + "_total", "counter", _fmt(v))
    for name, v in snapshot.get("gauges", {}).items():
        emit(_prom_name(name), "gauge", _fmt(v))
    for name, rec in snapshot.get("phases", {}).items():
        base = _prom_name(name)
        emit(base + "_seconds_total", "counter", _fmt(rec["total_s"]))
        emit(base + "_calls_total", "counter", _fmt(rec["calls"]))
        emit(base + "_max_seconds", "gauge", _fmt(rec["max_s"]))
    for name, h in snapshot.get("histograms", {}).items():
        base = _prom_name(name)
        lines.append(f"# TYPE {base} histogram")
        cum = 0
        for b in sorted(h.get("buckets", {}), key=float):
            cum += h["buckets"][b]
            lines.append(f'{base}_bucket{{le="{float(b):g}"}} {cum}')
        lines.append(f'{base}_bucket{{le="+Inf"}} {h["count"]}')
        lines.append(f"{base}_sum {_fmt(h.get('sum', 0.0))}")
        lines.append(f"{base}_count {h['count']}")
        # pre-computed p99.9 gauge: fleet-scale tail latency lives
        # past p99, and histogram_quantile() at p99.9 needs bucket
        # resolution a scraper cannot assume — export the registry's
        # own interpolated estimate alongside the native buckets
        if h.get("p999") is not None:
            emit(base + "_p999", "gauge", _fmt(h["p999"]))
    return "\n".join(lines) + "\n"


class MetricsExporter:
    """Periodic registry snapshotter: files + optional HTTP endpoint.

    ``start()`` writes one snapshot immediately (a run that dies
    before the first interval still leaves evidence) and launches the
    daemon thread; ``stop()`` writes a final snapshot and joins. The
    thread is a daemon either way — a forgotten exporter can never
    hold the process open.
    """

    def __init__(self, base_path: str = "",
                 interval_s: float = DEFAULT_INTERVAL_S,
                 port: int = -1,
                 registry: Optional[MetricsRegistry] = None):
        base = str(base_path or "")
        for suffix in (".prom", ".jsonl", ".json"):
            if base.endswith(suffix):
                base = base[: -len(suffix)]
        self.base_path = base
        self.interval_s = max(float(interval_s or DEFAULT_INTERVAL_S),
                              0.01)
        self.port = int(port)
        self._reg = registry or default_registry()
        self._stop_ev = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._server = None
        self._server_thread: Optional[threading.Thread] = None
        self._t0 = time.monotonic()
        self.snapshots_written = 0
        self._write_warned = False
        self._last_snapshot_t: Optional[float] = None   # monotonic

    # -- paths ---------------------------------------------------------------

    @property
    def prom_path(self) -> str:
        return f"{self.base_path}.prom" if self.base_path else ""

    @property
    def jsonl_path(self) -> str:
        return f"{self.base_path}.jsonl" if self.base_path else ""

    @property
    def http_port(self) -> Optional[int]:
        """The bound port (resolves port=0 ephemeral binds); None when
        no server is running."""
        if self._server is None:
            return None
        return self._server.server_address[1]

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "MetricsExporter":
        if self.port >= 0:
            try:
                self._start_server()
            except (OSError, OverflowError, ValueError) as e:
                # export is an observability aid: a taken/invalid port
                # (two runs sharing tpu_metrics_port, a bad extra_params
                # value) must not take training down — files still flow
                from ..utils import log
                log.warning("metrics HTTP endpoint on port %d failed "
                            "(%s); continuing without it", self.port, e)
                self._server = None
                self._server_thread = None
        self._write_once()
        self._thread = threading.Thread(
            target=self._run, name="metrics-exporter", daemon=True)
        self._thread.start()
        return self

    def stop(self, final_snapshot: bool = True) -> None:
        self._stop_ev.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self._server is not None:
            try:
                self._server.shutdown()
                self._server.server_close()
            except OSError:
                pass
            if self._server_thread is not None:
                self._server_thread.join(timeout=5.0)
            self._server = None
            self._server_thread = None
        if final_snapshot:
            self._write_once()

    def _run(self) -> None:
        while not self._stop_ev.wait(self.interval_s):
            self._write_once()

    # -- snapshot writers ----------------------------------------------------

    def _snapshot(self) -> dict:
        # exporter self-staleness: the age of the last COMPLETED
        # snapshot, refreshed on every snapshot read (a live /metrics
        # scrape of a wedged writer thread sees the age growing)
        if self._last_snapshot_t is not None:
            self._reg.gauge("exporter/last_snapshot_age_s").set(
                round(time.monotonic() - self._last_snapshot_t, 3))
        snap = self._reg.snapshot()
        snap["ts"] = round(time.time(), 3)
        snap["uptime_s"] = round(time.monotonic() - self._t0, 3)
        snap["identity"] = identity.identity()
        return snap

    def last_snapshot_age_s(self) -> Optional[float]:
        """Seconds since the last completed snapshot; None before the
        first one (the /healthz first-scrape race answers null, not a
        crash)."""
        if self._last_snapshot_t is None:
            return None
        return round(time.monotonic() - self._last_snapshot_t, 3)

    def _evaluate_slo(self) -> None:
        """The exporter thread IS the SLO engine's clock: evaluate the
        armed specs so the slo/* budget gauges land in the snapshot
        written right after (evaluate never raises)."""
        from . import slo as _slo
        eng = _slo.global_engine()
        if eng is not None:
            eng.evaluate()

    def _write_once(self) -> None:
        self._evaluate_slo()
        if not self.base_path:
            # HTTP-only mode: no files, but the tick still snapshots —
            # the flight recorder's recent-metrics ring must fill
            # whether or not anything lands on disk
            from . import flight as _flight
            fr = _flight.get()
            if fr is not None:
                fr.note_metrics(self._snapshot())
            self.snapshots_written += 1
            self._last_snapshot_t = time.monotonic()
            return
        try:
            from ..utils import faults
            if faults.active():
                faults.check("export.write")
            snap = self._snapshot()
            # .prom: atomic replace (scrapers must never read a torn
            # file); .jsonl: append-only time series
            with atomic_write(self.prom_path) as fh:
                fh.write(prometheus_text(snap))
            with open(self.jsonl_path, "a") as fh:
                fh.write(json.dumps(snap) + "\n")
            self.snapshots_written += 1
            self._last_snapshot_t = time.monotonic()
            # black-box feed: the flight recorder keeps the last few
            # interval snapshots' counters/gauges (obs/flight.py)
            from . import flight as _flight
            fr = _flight.get()
            if fr is not None:
                fr.note_metrics(snap)
        except Exception as e:          # noqa: BLE001 — export is an
            # observability aid; a full disk (or an injected
            # export.write fault) must not take training down — but an
            # operator watching for files that never appear deserves
            # ONE diagnostic
            if not self._write_warned:
                self._write_warned = True
                from ..utils import log
                log.warning("metrics export to %s failing (%s); will "
                            "keep retrying silently", self.base_path, e)

    # -- operational bodies --------------------------------------------------

    def health(self) -> dict:
        """The ``GET /healthz`` body: liveness, last-snapshot age and
        the compact SLO budget state. Total by construction — it must
        answer 200 on the very first scrape, before any snapshot has
        completed (``last_snapshot_age_s`` is null then) and with no
        SLO engine armed (``slo`` is null)."""
        from . import flight as _flight
        from . import slo as _slo
        eng = _slo.global_engine()
        slo_state = None
        budget_ok = True
        if eng is not None:
            try:
                slo_state = eng.summary()
                budget_ok = not slo_state.get("exhausted")
            except Exception:           # noqa: BLE001 — health must
                slo_state = {"error": "slo summary failed"}
        alive = not self._stop_ev.is_set()
        return {
            "ok": bool(alive and budget_ok),
            "alive": bool(alive),
            "budget_ok": bool(budget_ok),
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "interval_s": self.interval_s,
            "snapshots_written": self.snapshots_written,
            "last_snapshot_age_s": self.last_snapshot_age_s(),
            "slo": slo_state,
            "flight_dumps": len(_flight.dump_paths()),
        }

    def slo_report(self) -> dict:
        """The ``GET /slo`` body: the engine's full budget report, or
        an explicit not-armed shape (still 200 — a scraper probing a
        fleet must distinguish 'no SLOs configured' from 'down').

        Non-mutating: the EXPORTER interval is the engine's clock —
        a scrape returns the last evaluation (evaluating once only if
        none has happened yet), so an aggressive external scraper
        cannot shrink the burn-rate windows or inflate the gauge-tick
        budgets."""
        from . import slo as _slo
        eng = _slo.global_engine()
        if eng is None:
            return {"enabled": False, "specs": []}
        rep = dict(eng.report(fresh=False))
        rep["enabled"] = True
        return rep

    # -- HTTP ----------------------------------------------------------------

    def _start_server(self) -> None:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):              # noqa: N802 — stdlib API
                route = self.path.split("?")[0]
                if route == "/metrics":
                    body = prometheus_text(exporter._snapshot())
                    ctype = "text/plain; version=0.0.4"
                elif route == "/metrics.json":
                    body = json.dumps(exporter._snapshot())
                    ctype = "application/json"
                elif route in ("/healthz", "/health"):
                    body = json.dumps(exporter.health())
                    ctype = "application/json"
                elif route == "/slo":
                    body = json.dumps(exporter.slo_report())
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                data = body.encode()
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *a):      # silence per-request stderr
                pass

        self._server = ThreadingHTTPServer(("127.0.0.1", max(self.port, 0)),
                                           Handler)
        self._server.daemon_threads = True
        self._server_thread = threading.Thread(
            target=self._server.serve_forever, name="metrics-http",
            daemon=True)
        self._server_thread.start()


# ---------------------------------------------------------------------------
# process-global exporter (drivers join it; tests build private ones)
# ---------------------------------------------------------------------------

_global: Optional[MetricsExporter] = None
_global_lock = threading.Lock()
_atexit_installed = False


def _atexit_flush() -> None:
    """Final snapshot at interpreter exit (the tracer's safety-net
    pattern): without it, everything recorded in the last interval
    window — the final lrb windows, finish-time counters — would be
    missing from the on-disk artifacts."""
    ex = _global
    if ex is not None:
        try:
            ex.stop(final_snapshot=True)
        except Exception:               # noqa: BLE001 — teardown
            pass


def ensure_from_config(config) -> Optional[MetricsExporter]:
    """Start the process-global exporter when ``tpu_metrics_export``
    (or ``tpu_metrics_port`` > 0) is configured; later callers with the
    same base path join the running daemon. Accepts a Config or a raw
    params dict."""
    global _global
    base = str(config_get(config, "tpu_metrics_export", "") or "")
    port = int(config_get(config, "tpu_metrics_port", 0) or 0)
    if not base and port <= 0:
        return None
    # cluster policy (obs/identity.py): every rank gets its own file
    # target (no more atomic-replace races on one .prom), and only
    # rank 0 serves HTTP — by policy, not by bind-failure accident
    base = identity.rank_suffixed(base)
    if port > 0 and identity.is_multiprocess() and identity.rank() != 0:
        from ..utils import log
        log.info("metrics HTTP endpoint is rank-0-only; rank %d "
                 "exports to files/ring only", identity.rank())
        port = 0
    interval = float(config_get(config, "tpu_metrics_interval_s",
                                DEFAULT_INTERVAL_S)
                     or DEFAULT_INTERVAL_S)
    global _atexit_installed
    with _global_lock:
        if _global is not None:
            if base and _global.base_path != base:
                from ..utils import log
                log.warning(
                    "metrics exporter already running to %s; "
                    "tpu_metrics_export=%s ignored for this process "
                    "(one exporter per process)",
                    _global.base_path or "<http only>", base)
            return _global
        _global = MetricsExporter(
            base_path=base, interval_s=interval,
            port=port if port > 0 else -1).start()
        if not _atexit_installed:
            atexit.register(_atexit_flush)
            _atexit_installed = True
        from ..utils import log
        where = []
        if base:
            where.append(f"{base}.prom/.jsonl every {interval:g}s")
        if _global.http_port is not None:
            where.append(f"http://127.0.0.1:{_global.http_port}/metrics")
        log.info("metrics exporter started (%s)", ", ".join(where))
        return _global


def global_exporter() -> Optional[MetricsExporter]:
    return _global


def shutdown() -> None:
    """Stop the process-global exporter (tests / clean teardown)."""
    global _global
    with _global_lock:
        if _global is not None:
            _global.stop()
            _global = None
