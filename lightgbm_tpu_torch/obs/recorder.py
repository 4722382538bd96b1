"""Per-iteration run recording and the versioned run-report artifact.

The JAX package's ``obs/recorder.py``. The RunRecorder is the training
drivers' telemetry seam (``GBDT.train``, the CLI driver; ``engine.train``
through ``callback.record_run``): it times every boosting iteration,
samples the device memory in use and host-to-device byte deltas,
collects the per-iteration eval metric values, watches for
pathologically slow iterations, and at the end serializes the whole run
(iteration records plus the registry's phase table, counters and
histograms) to a versioned JSON (or JSONL) *run report* whose path comes
from the ``tpu_run_report`` config knob. The schema and version are the
JAX package's, so one reader (``load_run_report``) serves both packages;
readers check ``schema``/``version`` and refuse to misparse a future
layout.

Where the port differs: the device memory in use is
``torch.cuda.memory_stats(device)["allocated_bytes.all.current"]`` of
the booster's device (``device``; the JAX package asks
``jax.local_devices()[0].memory_stats()``), recorded per iteration as
``hbm_bytes_in_use``, and the run's peak as ``meta.peak_device_bytes``
(the device's peak statistic, restarted when a recorder with a report
path starts); on the CPU both are left out (the peak is null). Host-to-device bytes are the
sum of the registry's ``*h2d*bytes`` counters (the port's
``ingest/h2d_bytes``).

The recorder also owns two run-scoped behaviors:

- the structured log prefix: while a run is active every log line
  carries ``[t+<elapsed>s it=<iteration>]`` (utils/log.py
  set_run_context), so interleaved worker-thread logs are attributable;
- the slow-iteration watchdog: an iteration slower than
  ``tpu_watchdog_factor`` x the trailing median (last 64 iterations,
  armed after 8) logs a warning with the current phase table and
  triggers the flight recorder (obs/flight.py).
"""
from __future__ import annotations

import json
import statistics
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional

from ..analysis import lockorder
from ..utils import log, timing
from . import identity
from . import trace
from .registry import MetricsRegistry, default_registry

RUN_REPORT_SCHEMA = "lightgbm-tpu/run-report"
RUN_REPORT_VERSION = 1

# watchdog shape: median over this many trailing iterations, armed only
# once this many samples exist (the compile-heavy first iterations must
# not be judged against an empty history)
WATCHDOG_WINDOW = 64
WATCHDOG_MIN_HISTORY = 8


def _device_stats(device) -> Optional[dict]:
    """(bytes in use, peak bytes) of a CUDA ``device`` from
    ``torch.cuda.memory_stats``; None on the CPU or without a device."""
    if device is None:
        return None
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(dev)
    return {"in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak": int(stats.get("allocated_bytes.all.peak", 0))}


class RunRecorder:
    """Collects one training run; serializes it to the run report."""

    def __init__(self, path: str = "", watchdog_factor: float = 0.0,
                 meta: Optional[dict] = None,
                 registry: Optional[MetricsRegistry] = None,
                 device=None):
        # one report per rank under world>1 (obs/identity.py) — N
        # ranks handed the same tpu_run_report must never clobber
        self.path = identity.rank_suffixed(path or "")
        self.watchdog_factor = float(watchdog_factor or 0.0)
        self.meta = dict(meta or {})
        self._reg = registry or default_registry()
        self._lock = lockorder.named_lock("obs.recorder._lock")
        self._by_it: Dict[int, dict] = {}
        # per-kind trailing windows ("iter" vs "sync" spans must not
        # be judged against each other's medians)
        self._recent: Dict[str, deque] = {}
        self._t0: Optional[float] = None
        self._started_unix: Optional[float] = None
        self._cur_it: Optional[int] = None
        self._span_t0: Optional[float] = None
        self._last_h2d = 0
        # the booster's device, whose memory each iteration samples
        self.device = device
        self._peak_device: Optional[int] = None
        self._finished = False

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "RunRecorder":
        self._t0 = time.monotonic()
        self._started_unix = time.time()
        if self.path and _device_stats(self.device) is not None:
            # the report's peak is the run's own: the device's peak
            # statistic restarts here
            import torch
            torch.cuda.reset_peak_memory_stats(self.device)
        self._last_h2d = self._h2d_total()
        log.set_run_context(self._log_context)
        return self

    def _log_context(self):
        if self._t0 is None:
            return None
        return (time.monotonic() - self._t0, self._cur_it)

    # -- per-iteration spans -------------------------------------------------

    @contextmanager
    def iteration(self, it: int):
        self.begin_iteration(it)
        try:
            yield
        finally:
            self.end_iteration(it)

    def begin_iteration(self, it: int) -> None:
        self._cur_it = it
        self._span_t0 = time.monotonic()

    def end_iteration(self, it: int, kind: str = "iter") -> None:
        t0 = self._span_t0
        self._span_t0 = None
        if t0 is None:
            return
        self.observe_iteration(it, time.monotonic() - t0, kind)

    def tick(self, it: int, evals=None) -> None:
        """Callback-driven span accounting (engine.train): called once
        after each iteration; the span is the time since the previous
        tick (or start). ``evals``: the iteration's
        evaluation_result_list ((dataset, metric, value, bigger)
        tuples)."""
        now = time.monotonic()
        t0 = self._span_t0 if self._span_t0 is not None else self._t0
        self._cur_it = it
        self._span_t0 = now
        if t0 is not None:
            self.observe_iteration(it, now - t0)
        if evals:
            for tup in evals:
                self.record_eval(it, str(tup[0]), str(tup[1]),
                                 float(tup[2]))

    def set_field(self, it: int, key: str, value) -> None:
        """Set ``key`` of iteration ``it``'s record (the distributed
        learners' ``comm_bytes``)."""
        rec = self._rec(it)
        with self._lock:
            rec[key] = value

    def observe_iteration(self, it: int, wall_s: float,
                          kind: str = "iter") -> None:
        """Record one iteration's wall time + device samples and run
        the watchdog. Public so the drivers (and tests) can feed spans
        they timed themselves. ``kind`` partitions the watchdog's
        trailing medians: a span the driver KNOWS performed a blocking
        drain is tagged kind="sync" and compared only against its
        kind (the port's loops read back every iteration, so its
        drivers record "iter" spans only)."""
        rec = self._rec(it)
        h2d = self._h2d_total()
        with self._lock:
            rec["wall_s"] = round(float(wall_s), 6)
            if kind != "iter":
                rec["sync"] = True
            if h2d > self._last_h2d:
                rec["h2d_bytes"] = h2d - self._last_h2d
            self._last_h2d = h2d
        mem = _device_stats(self.device)
        if mem is not None:
            with self._lock:
                rec["hbm_bytes_in_use"] = mem["in_use"]
                self._peak_device = max(self._peak_device or 0,
                                        mem["peak"])
            self._reg.gauge("device/hbm_bytes_in_use").set(mem["in_use"])
        self._reg.histogram("train/iteration_s").observe(wall_s)
        self._watchdog(it, wall_s, kind)

    def _watchdog(self, it: int, wall_s: float, kind: str) -> None:
        recent = self._recent.get(kind)
        if recent is None:
            recent = self._recent[kind] = deque(maxlen=WATCHDOG_WINDOW)
        armed = (self.watchdog_factor > 0
                 and len(recent) >= WATCHDOG_MIN_HISTORY)
        if armed:
            med = statistics.median(recent)
            if med > 0 and wall_s > self.watchdog_factor * med:
                self._reg.counter("watchdog/slow_iterations").add(1)
                # instant marker on the trace timeline: a slow
                # iteration is visible in Perfetto exactly where it
                # happened, not only as a log line
                trace.instant("watchdog/slow_iteration", cat="event",
                              args={"it": int(it),
                                    "wall_s": round(float(wall_s), 6),
                                    "median_s": round(float(med), 6)})
                log.warning(
                    "slow iteration %d: %.3f s vs trailing median "
                    "%.3f s (%.1fx, threshold %.1fx); phase table:\n%s",
                    it, wall_s, med, wall_s / med, self.watchdog_factor,
                    timing.report() or "  (no phases recorded)")
                # black box: the watchdog firing is a postmortem
                # moment — dump the flight bundle with the state AT
                # the stall, not whatever survives to run end
                # (rate-limited there; obs/flight.py)
                from . import flight
                flight.trigger("watchdog",
                               {"it": int(it),
                                "wall_s": round(float(wall_s), 6),
                                "median_s": round(float(med), 6),
                                "factor": self.watchdog_factor})
        recent.append(float(wall_s))

    # -- per-iteration fields ------------------------------------------------

    def _rec(self, it: int) -> dict:
        with self._lock:
            rec = self._by_it.get(it)
            if rec is None:
                rec = self._by_it[it] = {"it": int(it)}
            return rec

    def record_eval(self, it: int, dataset: str, metric: str,
                    value: float) -> None:
        rec = self._rec(it)
        with self._lock:
            rec.setdefault("evals", {}).setdefault(dataset, {})[metric] \
                = float(value)

    def set_field(self, it: int, key: str, value) -> None:
        rec = self._rec(it)
        with self._lock:
            rec[key] = value

    def _h2d_total(self) -> int:
        """Total host->device bytes across every transfer counter (the
        ingest routes' ``ingest/h2d_bytes``, io/ingest.py)."""
        return sum(v for k, v in self._reg.counter_items().items()
                   if "h2d" in k and k.endswith("bytes"))

    # -- report --------------------------------------------------------------

    def finish(self, leaves_per_iteration: Optional[List[List[int]]] = None,
               waves_per_iteration: Optional[List[int]] = None,
               extra: Optional[dict] = None) -> dict:
        """Assemble the run report (and write it when a path is set).
        ``leaves_per_iteration``: [iteration][class-tree] leaf counts,
        filled by the driver at the end of the run. Idempotent: the
        first call wins."""
        if self._finished:
            return {}
        self._finished = True
        log.set_run_context(None)
        # cross-link report <-> trace: flush the tracer's ring so the
        # trace on disk covers this run, and record where it went
        if trace.enabled():
            trace_path = trace.write()
            if trace_path:
                self.meta.setdefault("trace_path", trace_path)
        # cross-link report <-> flight dumps: any postmortem bundle
        # the black box wrote this process (watchdog, faults, degraded
        # windows, SLO exhaustion — obs/flight.py) is findable FROM
        # the run report
        from . import flight
        dumps = flight.dump_paths()
        if dumps:
            self.meta.setdefault("flight_dumps", dumps)
        # who produced this report: rank/world/incarnation — the key
        # a cross-rank investigation joins artifacts on
        self.meta.setdefault("identity", identity.identity())
        # the device memory's peak over the sampled iterations (null on
        # the CPU)
        self.meta.setdefault("peak_device_bytes", self._peak_device)
        if leaves_per_iteration is not None:
            for i, grp in enumerate(leaves_per_iteration):
                self._rec(i + 1)["leaves"] = [int(x) for x in grp]
        if waves_per_iteration is not None:
            for i, w in enumerate(waves_per_iteration):
                self._rec(i + 1)["waves"] = int(w)
        snap = self._reg.snapshot()
        phases = dict(sorted(snap["phases"].items(),
                             key=lambda kv: -kv[1]["total_s"]))
        with self._lock:
            iterations = [self._by_it[k] for k in sorted(self._by_it)]
        report = {
            "schema": RUN_REPORT_SCHEMA,
            "version": RUN_REPORT_VERSION,
            "created_unix": (round(self._started_unix, 3)
                             if self._started_unix else None),
            "wall_s": (round(time.monotonic() - self._t0, 6)
                       if self._t0 is not None else None),
            "meta": self.meta,
            "phases": phases,
            "counters": snap["counters"],
            "gauges": snap["gauges"],
            "histograms": snap["histograms"],
            "iterations": iterations,
        }
        if extra:
            report["extra"] = dict(extra)
        if self.path:
            try:
                self._write(report)
                log.info("run report written to %s (%d iterations)",
                         self.path, len(iterations))
            except OSError as e:
                log.warning("could not write run report %s: %s",
                            self.path, e)
        return report

    def _write(self, report: dict) -> None:
        """Atomic write (utils/fileio.py, the tuning-cache discipline).
        ``*.jsonl`` paths stream one record per line — header,
        iterations, summary — so megarun reports stay grep/tail-able;
        anything else is one JSON document."""
        from ..utils.fileio import atomic_write
        with atomic_write(self.path) as fh:
            if self.path.endswith(".jsonl"):
                head = {k: report[k] for k in
                        ("schema", "version", "created_unix", "meta")}
                head["kind"] = "header"
                fh.write(json.dumps(head) + "\n")
                for rec in report["iterations"]:
                    fh.write(json.dumps({"kind": "iteration", **rec})
                             + "\n")
                summary = {"kind": "summary"}
                for k in ("wall_s", "phases", "counters", "gauges",
                          "histograms", "extra"):
                    if k in report:
                        summary[k] = report[k]
                fh.write(json.dumps(summary) + "\n")
            else:
                json.dump(report, fh, indent=1)


def load_run_report(path: str) -> dict:
    """Parse a run report (either format) back into the ``finish()``
    dict shape; raises ValueError on schema/version mismatch — a
    future layout is refused, never misread."""
    with open(path) as fh:
        if path.endswith(".jsonl"):
            report: dict = {"iterations": []}
            for ln in fh:
                ln = ln.strip()
                if not ln:
                    continue
                rec = json.loads(ln)
                kind = rec.pop("kind", None)
                if kind == "iteration":
                    report["iterations"].append(rec)
                else:                   # header / summary merge flat
                    report.update(rec)
        else:
            report = json.load(fh)
    if report.get("schema") != RUN_REPORT_SCHEMA:
        raise ValueError(f"{path}: not a run report "
                         f"(schema={report.get('schema')!r})")
    if report.get("version") != RUN_REPORT_VERSION:
        raise ValueError(f"{path}: run report version "
                         f"{report.get('version')!r}, reader wants "
                         f"{RUN_REPORT_VERSION}")
    return report
