"""SLO / error-budget engine: declarative objectives evaluated live
against the metrics registry.

The JAX package's ``obs/slo.py``, whole but for the piece below. An
**SLO spec** names an indicator and a threshold, the engine evaluates
the specs continuously, and the results are first-class gauges —
current value, compliance, **remaining error budget** and **burn
rate** — that ride the exporter's Prometheus text and JSONL time series
(obs/export.py) and the bodies of ``GET /healthz`` / ``GET /slo``.

Who evaluates it: the metrics exporter's thread evaluates the
process-global engine (``configure`` / ``ensure_from_config``, armed by
``tpu_slo``) every snapshot interval, as in the JAX package; the fleet
scoring daemon's admission controller (serve/daemon.py ``shed_check``)
is its own engine's evaluation clock, and with an exporter running the
exporter evaluates the global engine too.

Left out: the ``cluster/`` branch of ``_registry_for``. There it reads
the rank-0 rollup registry of the cluster view (``obs/clusterobs.py``),
which the port does not have until ROADMAP item 19; every instrument,
``cluster/`` names included, is read from the engine's own registry.

Neither package's predict path records ``predict/latency_s``: in the
repo only the JAX package's bench script (``bench.py``) writes that
histogram, once a batch. So here, as there, a ``predict_pNN_ms`` spec
has no events unless a bench feeds it, and stays compliant; the fleet's
``fleet/tenant_latency_s/<t>`` and the LRB loop's ``lrb/*`` instruments
are recorded.

Spec grammar (``tpu_slo``; ``;``-separated, ops ``<``/``<=``/``>``/
``>=``)::

    predict_p99_ms < 50            # 99% of predict batches under 50 ms
    serve_p999_ms < 20             # lrb serving tail at p99.9
    window_wall_p95_s < 30         # lrb window walls
    staleness_windows <= 2         # gauge lrb/model_staleness_windows
    degraded_window_rate < 0.05    # degraded / total windows
    hist:predict/latency_s:p99 < 0.05      # any histogram, seconds
    gauge:device/hbm_bytes_in_use < 2e9    # any gauge
    ratio:lrb/windows_failed|lrb/windows_total < 0.01  # any counters

Budget math (each spec carries an implied *objective* — the compliant
event fraction):

- **quantile specs** (``*_pNN_*``, ``hist:``): every histogram
  observation is an event; a bad event exceeds the threshold (bucket
  counts via ``Histogram.count_le`` — no per-sample storage). The
  objective is the quantile itself (``p99`` -> 0.99), so the error
  budget is the ``1 - q`` fraction of events: ``budget_remaining = 1 -
  bad / ((1 - q) * total)`` and the burn rate over the last evaluation
  interval is ``(bad_delta / total_delta) / (1 - q)`` — burn 1.0 means
  "exactly spending the budget", >1 means an alert-worthy burn.
- **ratio specs**: numerator counts bad events, denominator total; the
  threshold IS the budget fraction (``degraded_window_rate < 0.05``
  budgets 5% of windows): ``budget_remaining = 1 - num / (thr * den)``,
  ``burn = (num_delta / den_delta) / thr``.
- **gauge specs**: each evaluation tick is an event; a bad tick fails
  the comparison. Ticks are budgeted at the default objective
  ``GAUGE_OBJECTIVE`` (99% of ticks must comply).

Budget exhaustion (remaining <= 0) latches once per spec, logs one
warning and triggers the flight recorder (obs/flight.py): the postmortem
bundle lands at the moment the budget ran out.

Standard library only; evaluation never raises (the exporter thread and
the daemon's request threads must survive any spec/registry state).
"""
from __future__ import annotations

import re
import threading
import time
from typing import List, Optional

from ..analysis import lockorder
from .registry import MetricsRegistry, default_registry
from .trace import config_get

__all__ = [
    "SloSpec", "SloEngine", "parse_specs", "configure",
    "ensure_from_config", "global_engine", "shutdown",
    "GAUGE_OBJECTIVE",
]

# gauge specs budget evaluation ticks, not request events: allow 1% of
# ticks out of compliance before the budget burns dry
GAUGE_OBJECTIVE = 0.99

_OPS = {
    "<=": lambda a, b: a <= b,
    "<": lambda a, b: a < b,
    ">=": lambda a, b: a >= b,
    ">": lambda a, b: a > b,
}

# named indicators -> (histogram name, value scale seconds->unit)
_NAMED_HISTS = {
    "predict": ("predict/latency_s", "ms"),
    "serve": ("lrb/serve_latency_s", "ms"),
    "window_wall": ("lrb/window_wall_s", "s"),
}
_NAMED_GAUGES = {
    "staleness_windows": "lrb/model_staleness_windows",
}
_NAMED_RATIOS = {
    "degraded_window_rate": ("lrb/windows_degraded", "lrb/windows_total"),
}

_QUANT_RE = re.compile(
    r"^(?P<base>[a-z_]+)_p(?P<q>\d{2,4})_(?P<unit>ms|s)$")
_OP_RE = re.compile(r"(<=|>=|<|>)")


def _q_from_digits(digits: str) -> float:
    """'50' -> 0.50, '95' -> 0.95, '99' -> 0.99, '999' -> 0.999.
    Tokens longer than two digits with a trailing zero ('100', '500')
    are ambiguous aliases of shorter tokens — 'p100' would silently
    mean p10 — so they map out of range and the callers' 0 < q < 1
    check rejects the spec with a 'not a quantile' error."""
    if len(digits) > 2 and digits.endswith("0"):
        return -1.0
    return int(digits) / float(10 ** len(digits))


class SloSpec:
    """One parsed objective: an indicator read, a comparison, and the
    budget parameters the engine's math runs on."""

    __slots__ = ("text", "name", "kind", "source", "source_den", "op",
                 "op_fn", "threshold", "threshold_s", "objective",
                 "unit", "quantile")

    def __init__(self, text: str, name: str, kind: str, source: str,
                 op: str, threshold: float, objective: float,
                 unit: str = "", quantile: Optional[float] = None,
                 source_den: str = "", threshold_s: Optional[float] = None):
        self.text = text
        self.name = name            # gauge-safe label, e.g. predict_p99_ms
        self.kind = kind            # "quantile" | "gauge" | "ratio"
        self.source = source        # registry instrument name
        self.source_den = source_den
        self.op = op
        self.op_fn = _OPS[op]
        self.threshold = float(threshold)   # in the spec's display unit
        self.threshold_s = (self.threshold if threshold_s is None
                            else float(threshold_s))  # seconds (hists)
        self.objective = float(objective)   # compliant event fraction
        self.unit = unit
        self.quantile = quantile


def _parse_one(part: str) -> SloSpec:
    m = _OP_RE.search(part)
    if not m:
        raise ValueError(f"SLO spec {part!r}: no comparison operator "
                         f"(want one of {'/'.join(_OPS)})")
    indicator = part[: m.start()].strip()
    op = m.group(1)
    try:
        threshold = float(part[m.end():].strip())
    except ValueError:
        raise ValueError(f"SLO spec {part!r}: threshold "
                         f"{part[m.end():].strip()!r} is not a number")
    label = re.sub(r"[^A-Za-z0-9_]", "_", indicator)

    # named quantile indicators: predict_p99_ms, serve_p999_ms, ...
    qm = _QUANT_RE.match(indicator)
    if qm and qm.group("base") in _NAMED_HISTS:
        hist, unit = _NAMED_HISTS[qm.group("base")]
        if qm.group("unit") != unit:
            raise ValueError(
                f"SLO spec {part!r}: {qm.group('base')} quantiles are "
                f"expressed in {unit}, not {qm.group('unit')}")
        q = _q_from_digits(qm.group("q"))
        if not 0.0 < q < 1.0:
            raise ValueError(f"SLO spec {part!r}: p{qm.group('q')} is "
                             f"not a quantile")
        scale = 1e-3 if unit == "ms" else 1.0
        return SloSpec(part, label, "quantile", hist, op, threshold,
                       objective=q, unit=unit, quantile=q,
                       threshold_s=threshold * scale)
    if indicator in _NAMED_GAUGES:
        return SloSpec(part, label, "gauge", _NAMED_GAUGES[indicator],
                       op, threshold, objective=GAUGE_OBJECTIVE)
    if indicator in _NAMED_RATIOS:
        num, den = _NAMED_RATIOS[indicator]
        if op not in ("<", "<="):
            raise ValueError(f"SLO spec {part!r}: rate objectives are "
                             f"upper bounds (< or <=)")
        if not 0.0 < threshold <= 1.0:
            raise ValueError(f"SLO spec {part!r}: rate threshold "
                             f"{threshold} outside (0, 1]")
        return SloSpec(part, label, "ratio", num, op, threshold,
                       objective=1.0 - threshold, source_den=den)
    # generic escape hatches
    if indicator.startswith("hist:"):
        rest = indicator[len("hist:"):]
        src, sep, qtok = rest.rpartition(":")
        if not sep or not qtok.startswith("p"):
            raise ValueError(f"SLO spec {part!r}: want "
                             f"hist:<name>:p<NN> {op} <seconds>")
        q = _q_from_digits(qtok[1:])
        if not 0.0 < q < 1.0:
            raise ValueError(f"SLO spec {part!r}: {qtok} is not a "
                             f"quantile")
        return SloSpec(part, re.sub(r"[^A-Za-z0-9_]", "_", rest),
                       "quantile", src, op, threshold, objective=q,
                       unit="s", quantile=q)
    if indicator.startswith("gauge:"):
        src = indicator[len("gauge:"):]
        return SloSpec(part, re.sub(r"[^A-Za-z0-9_]", "_", src),
                       "gauge", src, op, threshold,
                       objective=GAUGE_OBJECTIVE)
    if indicator.startswith("ratio:"):
        rest = indicator[len("ratio:"):]
        num, sep, den = rest.partition("|")
        if not sep:
            raise ValueError(f"SLO spec {part!r}: want "
                             f"ratio:<num>|<den> {op} <fraction>")
        if not 0.0 < threshold <= 1.0:
            raise ValueError(f"SLO spec {part!r}: rate threshold "
                             f"{threshold} outside (0, 1]")
        return SloSpec(part, re.sub(r"[^A-Za-z0-9_]", "_", rest),
                       "ratio", num, op, threshold,
                       objective=1.0 - threshold, source_den=den)
    raise ValueError(
        f"SLO spec {part!r}: unknown indicator {indicator!r} (named: "
        f"{', '.join(sorted(list(_NAMED_GAUGES) + list(_NAMED_RATIOS)))}"
        f", <base>_pNN_<unit> for {'/'.join(sorted(_NAMED_HISTS))}, or "
        f"hist:/gauge:/ratio: forms)")


def parse_specs(text: str) -> List[SloSpec]:
    """Parse a ``tpu_slo`` spec string into SloSpec objects; raises
    ValueError with the offending fragment on any malformed spec."""
    specs = []
    for part in str(text or "").split(";"):
        part = part.strip()
        if part:
            specs.append(_parse_one(part))
    return specs


class SloEngine:
    """Evaluates parsed specs against a registry; maintains per-spec
    budget/burn state and publishes it as gauges."""

    def __init__(self, specs: List[SloSpec],
                 registry: Optional[MetricsRegistry] = None,
                 min_events: int = 0):
        self.specs = list(specs)
        self._reg = registry or default_registry()
        # event floor for budget judgment: below this population a
        # tail objective is statistically meaningless (ONE outlier
        # "exhausts" a p99 budget over 10 events) — specs stay
        # vacuously compliant, budget untouched, until the floor is
        # met. 0 keeps the historical judge-from-event-1 behavior;
        # the fleet admission controller (serve/daemon.py) sets ~100
        # so a cold-start outlier cannot latch exhaustion.
        self._min_events = max(int(min_events), 0)
        self._lock = lockorder.named_lock("obs.slo._lock")
        # per-spec accounting: cumulative (total, bad) at the last
        # evaluation (burn deltas), tick counts for gauge specs, and
        # the exhaustion latch (one warning and flight trigger per spec)
        self._last = [(0, 0)] * len(self.specs)
        self._ticks = [0] * len(self.specs)
        self._bad_ticks = [0] * len(self.specs)
        self._exhausted = [False] * len(self.specs)
        self._evaluations = 0
        self._last_report: Optional[dict] = None

    @classmethod
    def from_spec(cls, text: str,
                  registry: Optional[MetricsRegistry] = None
                  ) -> "SloEngine":
        return cls(parse_specs(text), registry=registry)

    # -- per-spec reads ------------------------------------------------------

    def _registry_for(self, name: str) -> MetricsRegistry:
        """The registry ``name`` is read from: this engine's own. (The
        JAX package reads ``cluster/...`` names from its cluster
        rollup; see the module docstring.)"""
        return self._reg

    # bounded-cardinality: every dynamic metric name in this method
    # is a source from the parsed tpu_slo spec list (validated at
    # config time) — one series per configured objective
    def _events(self, spec: SloSpec):
        """-> (current, total_events, bad_events) for one spec; current
        is in the spec's display unit."""
        if spec.kind == "quantile":
            h = self._registry_for(spec.source).histogram(spec.source)
            # ONE consistent read: total and the <=-threshold count
            # must come from the same instant or concurrent observes
            # make bad negative (and corrupt the next burn delta)
            total, good = h.count_and_le(spec.threshold_s)
            if not total:
                return None, 0, 0
            cur = h.percentile(spec.quantile)
            if cur is not None and spec.unit == "ms":
                cur *= 1e3
            bad = (total - good if spec.op in ("<", "<=") else good)
            return cur, total, bad
        if spec.kind == "ratio":
            # read NUM before DEN: producers count the denominator
            # first (lrb._apply_train_outcome), so with this order a
            # concurrent window can only make the ratio smaller —
            # never show a bad event without its denominator (which
            # would overshoot the rate and falsely latch exhaustion)
            src_reg = self._registry_for(spec.source)
            num = src_reg.counter(spec.source).value
            den = src_reg.counter(spec.source_den).value
            cur = (num / den) if den else None
            return cur, den, num
        # gauge: ticks are counted by evaluate()
        cur = self._registry_for(spec.source).gauge(spec.source).value
        return cur, None, None

    # -- evaluation ----------------------------------------------------------

    def evaluate(self) -> dict:
        """One evaluation pass: per-spec compliance, budget and burn,
        published as ``slo/*`` gauges; returns (and stores) the full
        report. Never raises — the exporter thread calls this every
        interval, the daemon's request threads on the admission path."""
        try:
            return self._evaluate()
        except Exception as e:          # noqa: BLE001 — the caller's
            # thread must survive any registry/spec state
            from ..utils import log
            log.warning("SLO evaluation failed (%s); keeping last "
                        "report", e)
            return self._last_report or {"specs": [], "ok": None}

    # bounded-cardinality: the slo/<name>/* gauge family is one
    # series-set per configured objective (tpu_slo is a validated,
    # finite spec list)
    def _evaluate(self) -> dict:
        with self._lock:
            self._evaluations += 1
            rows = []
            exhausted_now = []
            for i, spec in enumerate(self.specs):
                cur, total, bad = self._events(spec)
                if spec.kind == "gauge":
                    # a never-written gauge is vacuously compliant
                    # (no data is not a violation — the first-scrape
                    # rule of /healthz applies here too)
                    ok = (cur is None
                          or bool(spec.op_fn(cur, spec.threshold)))
                    self._ticks[i] += 1
                    if not ok:
                        self._bad_ticks[i] += 1
                    total, bad = self._ticks[i], self._bad_ticks[i]
                else:
                    ok = (cur is None
                          or bool(spec.op_fn(cur, spec.threshold)))
                warming = (spec.kind != "gauge" and self._min_events > 0
                           and (total or 0) < self._min_events)
                if warming:
                    ok = True   # too few events to judge a tail
                budget_events = (1.0 - spec.objective) * (total or 0)
                if total and not warming:
                    remaining = (1.0 - bad / budget_events
                                 if budget_events > 0
                                 else (1.0 if not bad else 0.0))
                else:
                    remaining = 1.0
                lt, lb = self._last[i]
                dt, db = total - lt, bad - lb
                self._last[i] = (total, bad)
                allowed = 1.0 - spec.objective
                burn = ((db / dt) / allowed
                        if dt > 0 and allowed > 0 else 0.0)
                row = {
                    "spec": spec.text, "name": spec.name,
                    "kind": spec.kind, "ok": ok,
                    "current": (None if cur is None
                                else round(float(cur), 6)),
                    "threshold": spec.threshold,
                    "objective": spec.objective,
                    "events": total, "bad_events": bad,
                    "budget_remaining": round(remaining, 6),
                    "burn_rate": round(burn, 6),
                    "exhausted": bool(self._exhausted[i]
                                      or remaining <= 0.0),
                }
                if self._min_events:
                    row["warming"] = warming
                if remaining <= 0.0 and not self._exhausted[i]:
                    self._exhausted[i] = True
                    exhausted_now.append(row)
                rows.append(row)
            report = {
                "ts": round(time.time(), 3),
                "evaluations": self._evaluations,
                "specs": rows,
                "ok": all(r["ok"] for r in rows) if rows else True,
                "violating": sum(1 for r in rows if not r["ok"]),
                "budget_remaining_min": (
                    min(r["budget_remaining"] for r in rows)
                    if rows else None),
                "burn_rate_max": (max(r["burn_rate"] for r in rows)
                                  if rows else None),
                "exhausted": [r["name"] for r in rows if r["exhausted"]],
            }
            self._last_report = report
        # gauges OUTSIDE the engine lock (registry has its own)
        for r in rows:
            base = f"slo/{r['name']}"
            self._reg.gauge(base + "/ok").set(1.0 if r["ok"] else 0.0)
            if r["current"] is not None:
                self._reg.gauge(base + "/current").set(r["current"])
            self._reg.gauge(base + "/budget_remaining").set(
                r["budget_remaining"])
            self._reg.gauge(base + "/burn_rate").set(r["burn_rate"])
        if rows:
            self._reg.gauge("slo/violating").set(
                float(report["violating"]))
            self._reg.gauge("slo/budget_remaining_min").set(
                report["budget_remaining_min"])
        self._reg.counter("slo/evaluations").add(1)
        # budget exhaustion is a postmortem moment: dump the black box
        # NOW (latched per spec so a burned budget does not re-dump
        # every interval)
        for row in exhausted_now:
            from ..utils import log
            log.warning("SLO budget EXHAUSTED: %s (current=%s, "
                        "threshold=%s, bad %d of %d events)",
                        row["spec"], row["current"], row["threshold"],
                        row["bad_events"], row["events"])
            from . import flight
            flight.trigger("slo_budget_exhausted",
                           {"slo": row["name"], "spec": row["spec"],
                            "current": row["current"],
                            "bad_events": row["bad_events"],
                            "events": row["events"]}, force=True)
        return report

    def report(self, fresh: bool = True) -> dict:
        """The budget report (the ``GET /slo`` body). ``fresh=False``
        returns the last evaluation without re-evaluating (the flight
        recorder's non-reentrant read, the daemon's rate-limited
        admission reads)."""
        if fresh or self._last_report is None:
            return self.evaluate()
        return self._last_report

    def summary(self) -> dict:
        """The compact budget state for ``GET /healthz``."""
        rep = self._last_report or self.evaluate()
        return {
            "specs": len(rep.get("specs", [])),
            "ok": rep.get("ok"),
            "violating": rep.get("violating", 0),
            "budget_remaining_min": rep.get("budget_remaining_min"),
            "exhausted": rep.get("exhausted", []),
        }


# -- module-global engine ----------------------------------------------------

_global: Optional[SloEngine] = None
_global_lock = threading.Lock()


def configure(text: str,
              registry: Optional[MetricsRegistry] = None
              ) -> Optional[SloEngine]:
    """Install (or replace) the process-global engine from a spec
    string; empty disarms."""
    global _global
    with _global_lock:
        _global = SloEngine.from_spec(text, registry) if text else None
        return _global


def ensure_from_config(config) -> Optional[SloEngine]:
    """Install the global engine when ``tpu_slo`` is set; idempotent
    for the same spec text (every windowed booster re-inits)."""
    global _global
    text = str(config_get(config, "tpu_slo", "") or "")
    if not text:
        return _global
    with _global_lock:
        if (_global is not None
                and [s.text for s in _global.specs]
                == [s.strip() for s in text.split(";") if s.strip()]):
            return _global
        _global = SloEngine.from_spec(text)
        from ..utils import log
        log.info("SLO engine armed: %s",
                 "; ".join(s.text for s in _global.specs))
        return _global


def global_engine() -> Optional[SloEngine]:
    return _global


def shutdown() -> None:
    """Drop the global engine (tests)."""
    global _global
    with _global_lock:
        _global = None
