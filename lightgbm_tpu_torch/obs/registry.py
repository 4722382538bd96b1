"""Thread-safe metrics registry: counters, gauges, histograms, timers.

The JAX package's ``obs/registry.py``: the single accumulation point for
the port's telemetry. The LRB loop (lrb.py) counts windows, degrades and
model swaps here and keeps its window-wall and serving-latency
quantiles in log-bucketed latency histograms; retries and injected
faults are counted here (utils/retry.py, utils/faults.py); the phase
clocks of ``utils/timing.py`` (the file loader's parse and binning, the
CLI driver's phase report) are its timers; ``snapshot`` is the body of
the run report, the exporter's snapshots and the flight bundles.

Design constraints:

- **Thread-safe.** The LRB trainer and server threads record from
  off the main thread; every instrument mutation and every
  get-or-create takes the owning registry's lock. The lock is
  per-registry, not per-instrument: contention is negligible at
  telemetry rates and one lock keeps snapshot() atomic across domains.
- **Dependency-free.** This module imports only the standard library.
- **Plain monotonic time.** Durations are recorded by callers from
  ``time.monotonic()`` deltas; the registry itself never reads clocks.

Left out until its user is ported (ROADMAP item 19): the bucket merging
of the cluster view.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from ..analysis import lockorder

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "default_registry", "counter", "gauge", "histogram", "timer",
    "log_buckets", "latency_histogram", "LATENCY_BUCKETS_S",
    "quantile_label",
]


class Counter:
    """Monotonically increasing count (events, bytes, rows)."""
    __slots__ = ("_lock", "_value")

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self._value = 0

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Last-written value (model staleness, pipeline overlap)."""
    __slots__ = ("_lock", "_value")

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self._value: Optional[float] = None

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> Optional[float]:
        with self._lock:
            return self._value


# default histogram buckets: exponential, sized for seconds-grade
# durations (1 ms .. 60 s) but serviceable for any positive magnitude
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 25.0, 60.0)


def log_buckets(lo: float, hi: float,
                per_decade: int = 12) -> Tuple[float, ...]:
    """Geometric bucket bounds from ``lo`` to (at least) ``hi`` with
    ``per_decade`` buckets per factor of 10. At 12/decade adjacent
    bounds differ by ~21%, so an interpolated quantile (see
    ``Histogram.percentile``) lands within a fifth of the true value
    across seven decades with under a hundred buckets — the
    latency-quantile resolution/size trade."""
    import math
    lo = float(lo)
    per_decade = max(int(per_decade), 1)
    n = int(math.ceil(math.log10(float(hi) / lo) * per_decade))
    return tuple(lo * 10.0 ** (k / per_decade) for k in range(n + 1))


# latency preset: 1 µs .. 60 s — wide enough for a single predict
# dispatch at the bottom and a cold-compile window wall at the top
LATENCY_BUCKETS_S: Tuple[float, ...] = log_buckets(1e-6, 60.0, 12)


def quantile_label(q: float) -> str:
    """0.5 -> "p50", 0.95 -> "p95", 0.999 -> "p999" — the one naming
    rule for quantile keys in snapshots/result tables."""
    return "p" + f"{q * 100:g}".replace(".", "")


class Histogram:
    """Fixed-bucket histogram with percentile readout.

    Buckets are upper bounds (cumulative style); one implicit overflow
    bucket catches everything above the last bound. ``percentile``
    returns the upper bound of the bucket containing the requested
    rank (the observed max for the overflow bucket) — coarse by
    construction, stable under concurrency, no per-sample storage.
    """
    __slots__ = ("_lock", "buckets", "_counts", "_count", "_sum",
                 "_min", "_max")

    def __init__(self, lock: threading.RLock,
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        self._lock = lock
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._counts = [0] * (len(self.buckets) + 1)
        self._count = 0
        self._sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None

    def observe(self, v: float) -> None:
        self.observe_n(v, 1)

    def observe_n(self, v: float, n: int) -> None:
        """Record ``n`` observations of the same value in one bucket
        walk — the per-request normalization of a batched call: every
        request in a ``n``-row micro-batch experienced the batch's
        wall, so the batch contributes ``n`` request latencies, not
        one (lrb.py serve path). Quantiles then rank REQUESTS."""
        v = float(v)
        n = int(n)
        if n <= 0:
            return
        with self._lock:
            i = 0
            for i, b in enumerate(self.buckets):       # noqa: B007
                if v <= b:
                    break
            else:
                i = len(self.buckets)
            self._counts[i] += n
            self._count += n
            self._sum += v * n
            self._min = v if self._min is None else min(self._min, v)
            self._max = v if self._max is None else max(self._max, v)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, q: float) -> Optional[float]:
        """q-quantile (0 < q <= 1) with linear interpolation INSIDE the
        bucket holding the quantile rank: the rank's fractional position
        among the bucket's samples maps onto the bucket's [lower, upper)
        bound span — the Prometheus ``histogram_quantile`` estimator.
        Bounds are clamped to the observed min/max (the first bucket's
        lower edge is the observed min, the overflow bucket's upper edge
        the observed max), so a bucket holding one sample still reports
        a value inside the data range. None when empty."""
        with self._lock:
            if not self._count:
                return None
            rank = max(1, int(q * self._count + 0.999999))
            cum = 0
            for i, c in enumerate(self._counts):
                if not c:
                    continue
                cum += c
                if cum < rank:
                    continue
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = (self.buckets[i] if i < len(self.buckets)
                      else self._max)
                # clamp to observed range (min/max are exact)
                lo = max(lo, self._min)
                hi = max(min(hi, self._max), lo)
                frac = (rank - (cum - c)) / c
                return lo + (hi - lo) * frac
            return self._max

    def count_le(self, v: float) -> int:
        """Estimated number of observations <= ``v``: whole buckets
        below it plus a linear share of the bucket straddling it
        (the percentile() interpolation run in reverse, same min/max
        clamping) — the event count the SLO engine's error-budget
        math stands on (obs/slo.py). 0 when empty."""
        with self._lock:
            if not self._count:
                return 0
            v = float(v)
            if self._max is not None and v >= self._max:
                return self._count
            if self._min is not None and v < self._min:
                return 0
            cum = 0
            for i, c in enumerate(self._counts):
                if not c:
                    continue
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = (self.buckets[i] if i < len(self.buckets)
                      else self._max)
                lo = max(lo, self._min)
                hi = max(min(hi, self._max), lo)
                if v >= hi:
                    cum += c
                    continue
                if v >= lo:
                    frac = 1.0 if hi <= lo else (v - lo) / (hi - lo)
                    cum += int(c * frac)
                break
            return cum

    def count_and_le(self, v: float) -> Tuple[int, int]:
        """Consistent ``(count, count_le(v))`` under ONE lock hold
        (the lock is reentrant): the SLO engine's bad-event math
        (``bad = count - count_le``) must not straddle concurrent
        observes — a racing pair of reads can make it negative."""
        with self._lock:
            return self._count, self.count_le(v)

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            out = {"count": self._count, "sum": round(self._sum, 9),
                   "min": self._min, "max": self._max,
                   "buckets": {str(b): c for b, c in
                               zip(self.buckets, counts) if c},
                   "overflow": counts[-1]}
        for q, name in ((0.5, "p50"), (0.9, "p90"), (0.95, "p95"),
                        (0.99, "p99"), (0.999, "p999")):
            out[name] = self.percentile(q)
        return out

    def quantiles(self, qs=(0.5, 0.95, 0.99, 0.999)) -> dict:
        """{"p50": v, ..., "p999": v} readout for result tables
        (lrb.py window wall and serving latency); p99.9 rides along by
        default. Values None when empty."""
        return {quantile_label(q): self.percentile(q) for q in qs}


class Timer:
    """Accumulated duration: total seconds, call count, max call (the
    phase table of utils/timing.py)."""
    __slots__ = ("_lock", "_total", "_count", "_max")

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self._total = 0.0
        self._count = 0
        self._max = 0.0

    def add(self, seconds: float) -> None:
        seconds = float(seconds)
        with self._lock:
            self._total += seconds
            self._count += 1
            if seconds > self._max:
                self._max = seconds

    @property
    def total(self) -> float:
        with self._lock:
            return self._total

    @property
    def count(self) -> int:
        with self._lock:
            return self._count


class MetricsRegistry:
    """Named instruments in four domains under one lock."""

    def __init__(self):
        self._lock = lockorder.named_rlock("obs.registry._lock")
        self._counters: "OrderedDict[str, Counter]" = OrderedDict()   # guarded-by: _lock
        self._gauges: "OrderedDict[str, Gauge]" = OrderedDict()       # guarded-by: _lock
        self._histograms: "OrderedDict[str, Histogram]" = OrderedDict()  # guarded-by: _lock
        self._timers: "OrderedDict[str, Timer]" = OrderedDict()       # guarded-by: _lock

    # -- get-or-create accessors --------------------------------------------

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(self._lock)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(self._lock)
            return g

    def histogram(self, name: str,
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS
                  ) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(self._lock,
                                                       buckets)
            return h

    def timer(self, name: str) -> Timer:
        with self._lock:
            t = self._timers.get(name)
            if t is None:
                t = self._timers[name] = Timer(self._lock)
            return t

    def timer_items(self) -> List[Tuple[str, float, int, float]]:
        """[(name, total_s, calls, max_s)]: one consistent read."""
        with self._lock:
            return [(n, t._total, t._count, t._max)
                    for n, t in self._timers.items()]

    def counter_items(self) -> Dict[str, int]:
        with self._lock:
            return {n: c._value for n, c in self._counters.items()}

    def snapshot(self) -> dict:
        """JSON-able state of every instrument: the body of the run
        report (obs/recorder.py), the exporter's snapshots
        (obs/export.py) and the flight recorder's bundles."""
        with self._lock:
            counters = {n: c._value for n, c in self._counters.items()}
            gauges = {n: g._value for n, g in self._gauges.items()
                      if g._value is not None}
            hists = list(self._histograms.items())
            phases = {n: {"total_s": round(t._total, 6),
                          "calls": t._count,
                          "max_s": round(t._max, 6)}
                      for n, t in self._timers.items()}
        return {"counters": counters, "gauges": gauges,
                "histograms": {n: h.snapshot() for n, h in hists},
                "phases": phases}

    def reset_timers(self) -> None:
        """Clear the timer domain only (each phase report covers one
        run's deltas; counters keep accumulating)."""
        with self._lock:
            self._timers.clear()


# process-global default registry: the port's instruments all live
# here unless a caller (tests) builds a private MetricsRegistry
_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _default


def counter(name: str) -> Counter:
    return _default.counter(name)


def gauge(name: str) -> Gauge:
    return _default.gauge(name)


def histogram(name: str,
              buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
    return _default.histogram(name, buckets)


def timer(name: str) -> Timer:
    return _default.timer(name)


def latency_histogram(name: str,
                      registry: Optional[MetricsRegistry] = None
                      ) -> Histogram:
    """Get-or-create a log-bucketed latency instrument (1 µs – 60 s,
    12 buckets/decade): the quantile-grade preset behind
    ``lrb/window_wall_s`` and ``lrb/serve_latency_s`` (lrb.py)."""
    return (registry or _default).histogram(name, LATENCY_BUCKETS_S)
