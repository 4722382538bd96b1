"""Request-scoped wide events: the per-request identity of the
serving path.

The JAX package's ``obs/reqlog.py``. The registry's counters and
histograms are aggregate and the trace is span-shaped; neither answers
the first question about a slow or wrong answer: *which request*,
against *which model*, in *which window*? This module adds that
identity:

- **Request ids** are issued monotonically process-wide
  (``next_request_id``) by the serving entry points (the LRB loop's
  evaluation micro-batches and ``predict_live``) and carried through
  the predict stack in a thread-local *request context*
  (``request(...)``), so the layers in between can tag what they see:
  trace spans carry ``req_id``/``window`` in their args, and the
  serve-bucket seam (ops/predict_cache.py ``serve_bucket_rows``) notes
  the padded batch width the request actually rode (``note_bucket``).
- **Wide events**: ONE structured record per request batch and per LRB
  window, carrying everything an investigation needs in one line
  (latency, rows, the serving model's window, the serve bucket,
  degraded/staleness state), land in a bounded in-memory ring ALWAYS
  and, when ``tpu_reqlog`` names a path, in an append-only JSONL file.
- **Sampling** (``tpu_reqlog_sample``) applies to the FILE only, and
  is a deterministic pure function of the request id (a lowbias32
  hash): the same id is sampled on every run at the same rate, so two
  runs' logs cover the same requests. Window/degraded records are never
  sampled out: there are few and they are the ones postmortems start
  from.

Standard library only, like the registry and tracer. The flight
recorder (obs/flight.py) dumps the ring, which ``recent`` reads.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Optional

from ..analysis import lockorder
from . import identity
from .trace import config_get

__all__ = [
    "RequestLog", "next_request_id", "request", "current",
    "note_bucket", "record", "get", "ensure_from_config", "shutdown",
    "REQLOG_SCHEMA", "REQLOG_VERSION",
]

REQLOG_SCHEMA = "lightgbm-tpu/reqlog"
REQLOG_VERSION = 1

DEFAULT_RING_RECORDS = 1024

# record kinds that are never sampled out of the file: windows and
# degraded windows are few, and they anchor every postmortem
ALWAYS_LOGGED_KINDS = ("window", "degraded_window")

# -- request ids -------------------------------------------------------------

_id_lock = threading.Lock()
_next_id = 0


def next_request_id() -> int:
    """Monotonically-issued process-wide request/batch id (1-based)."""
    global _next_id
    with _id_lock:
        _next_id += 1
        return _next_id


def _mix32(x: int) -> int:
    """lowbias32: a cheap high-quality avalanche so consecutive ids
    sample independently."""
    x &= 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x7FEB352D) & 0xFFFFFFFF
    x ^= x >> 15
    x = (x * 0x846CA68B) & 0xFFFFFFFF
    x ^= x >> 16
    return x


# -- the thread-local request context ---------------------------------------


class RequestContext:
    """What the layers below the serving entry can see of the current
    request: its id, the window it belongs to, and (filled by the
    serve-bucket seam) the padded batch width it rode."""
    __slots__ = ("req_id", "window", "bucket")

    def __init__(self, req_id: int, window: Optional[int] = None):
        self.req_id = int(req_id)
        self.window = window
        self.bucket: Optional[int] = None


_tls = threading.local()


@contextmanager
def request(req_id: Optional[int] = None, window: Optional[int] = None):
    """Install a request context for the calling thread's predict
    path; nests (the previous context is restored on exit)."""
    rid = next_request_id() if req_id is None else int(req_id)
    prev = getattr(_tls, "ctx", None)
    ctx = RequestContext(rid, window)
    _tls.ctx = ctx
    try:
        yield ctx
    finally:
        _tls.ctx = prev


def current() -> Optional[RequestContext]:
    """The calling thread's active request context, or None."""
    return getattr(_tls, "ctx", None)


def note_bucket(bucket: int) -> None:
    """Called from the serve-bucket seam (ops/predict_cache.py
    serve_bucket_rows): record the padded width the current request's
    batch dispatched at. Free no-op without an active context."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is not None:
        ctx.bucket = int(bucket)


# -- the wide-event log ------------------------------------------------------


class RequestLog:
    """Bounded ring of wide events + optional sampled JSONL file."""

    def __init__(self, path: str = "", sample: float = 1.0,
                 ring_records: int = DEFAULT_RING_RECORDS,
                 registry=None):
        self.path = str(path or "")
        self.sample = min(max(float(sample), 0.0), 1.0)
        self._threshold = int(self.sample * 4294967296.0)
        self._ring: deque = deque(maxlen=max(int(ring_records), 16))
        self._lock = lockorder.named_lock("obs.reqlog._lock")
        self._fh = None
        self._write_warned = False
        if registry is None:
            from . import registry as _reg
            registry = _reg.default_registry()
        self._reg = registry
        self.records_written = 0

    # -- sampling ------------------------------------------------------------

    def sampled(self, req_id) -> bool:
        """Deterministic per-id file-sampling decision: a pure
        function of (id, rate) — every instance at the same rate
        samples the same ids."""
        if self.sample >= 1.0:
            return True
        if self.sample <= 0.0 or req_id is None:
            return False
        return _mix32(int(req_id)) < self._threshold

    # -- recording -----------------------------------------------------------

    def record(self, kind: str, req_id=None, **fields) -> dict:
        """One wide event: always into the ring, into the file when
        configured and (for request records) the id samples in. Returns
        the record."""
        rec = {"ts": round(time.time(), 6), "kind": str(kind)}
        if req_id is not None:
            rec["req_id"] = int(req_id)
        if identity.is_multiprocess():
            # every wide event carries its rank under world>1, so N
            # ranks' files interleave attributably (obs/identity.py)
            rec["rank"] = identity.rank()
            if identity.incarnation():
                rec["inc"] = identity.incarnation()
        for k, v in fields.items():
            if v is not None:
                rec[k] = v
        self._ring.append(rec)
        self._reg.counter("reqlog/records").add(1)
        if self.path and (kind in ALWAYS_LOGGED_KINDS
                          or self.sampled(req_id)):
            self._write(rec)
        return rec

    def _write(self, rec: dict) -> None:
        try:
            with self._lock:
                if self._fh is None:
                    # append-only JSONL: a header line makes the file
                    # self-describing for readers
                    self._fh = open(self.path, "a")
                    self._fh.write(json.dumps({
                        "kind": "header", "schema": REQLOG_SCHEMA,
                        "version": REQLOG_VERSION,
                        "sample": self.sample,
                        "identity": identity.identity(),
                        "started_unix": round(time.time(), 3)}) + "\n")
                self._fh.write(json.dumps(rec) + "\n")
                self._fh.flush()
                self.records_written += 1
        except Exception as e:          # noqa: BLE001 — observability
            # aid: a full disk must not take serving down, but the
            # operator deserves ONE diagnostic
            self._reg.counter("reqlog/write_failures").add(1)
            if not self._write_warned:
                self._write_warned = True
                from ..utils import log
                log.warning("request log %s failing (%s); in-memory "
                            "ring keeps recording", self.path, e)

    def recent(self, n: Optional[int] = None) -> list:
        """The newest ``n`` (default: all ringed) wide events: the
        flight recorder pulls these into its postmortem bundle."""
        out = list(self._ring)
        return out if n is None else out[-int(n):]

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None


# -- module-global instance (drivers join it; tests build private ones) ------

_global: Optional[RequestLog] = None
_global_lock = threading.Lock()


def get(create: bool = True) -> Optional[RequestLog]:
    """The process-global request log; created ring-only on first use
    (the ring is the always-on half — a file needs ``tpu_reqlog``)."""
    global _global
    if _global is None and create:
        with _global_lock:
            if _global is None:
                _global = RequestLog()
    return _global


def record(kind: str, req_id=None, **fields) -> dict:
    """Record a wide event on the global log (see RequestLog.record)."""
    return get().record(kind, req_id=req_id, **fields)


def ensure_from_config(config) -> Optional[RequestLog]:
    """Configure the global log from ``tpu_reqlog`` (file path) and
    ``tpu_reqlog_sample`` (deterministic per-id file sampling rate).
    Idempotent; a later caller naming a DIFFERENT path warns and keeps
    the running log (one request log per process)."""
    global _global
    path = str(config_get(config, "tpu_reqlog", "") or "")
    # one wide-event file per rank under world>1 (obs/identity.py) —
    # append-mode interleave across processes would tear records
    path = identity.rank_suffixed(path)
    sample = float(config_get(config, "tpu_reqlog_sample", 1.0))
    with _global_lock:
        if _global is None:
            _global = RequestLog(path, sample)
            if path:
                from ..utils import log
                log.info("request log -> %s (sample %g)", path, sample)
            return _global
        if path and not _global.path:
            # a ring-only default upgraded to a file by the first
            # driver that names one: adopt path AND rate together
            _global.path = path
            _global.sample = min(max(sample, 0.0), 1.0)
            _global._threshold = int(_global.sample * 4294967296.0)
            from ..utils import log
            log.info("request log -> %s (sample %g)", path, sample)
        elif path and _global.path != path:
            from ..utils import log
            log.warning("request log already writing to %s; "
                        "tpu_reqlog=%s ignored for this process "
                        "(one request log per process)",
                        _global.path, path)
        return _global


def shutdown() -> None:
    """Close and drop the global log (tests / clean teardown)."""
    global _global
    with _global_lock:
        if _global is not None:
            _global.close()
            _global = None
