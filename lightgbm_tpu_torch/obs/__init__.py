"""Observability of the port (the JAX package's ``obs/``; standard library
only, but for the profiler window, which runs torch.profiler):

- ``obs.registry``: thread-safe counters, gauges and log-bucketed
  latency histograms with quantile readout;
- ``obs.trace``: the ring-buffered Chrome trace-event recorder
  (``tpu_trace``/``tpu_trace_buffer``), off unless ``tpu_trace`` names a
  file;
- ``obs.reqlog``: request ids, the thread-local request context and
  one wide event per request batch and per LRB window (``tpu_reqlog``/
  ``tpu_reqlog_sample``);
- ``obs.identity``: the (rank, world, incarnation) record artifacts
  carry;
- ``obs.slo``: the SLO / error-budget engine (``tpu_slo``), evaluated by
  the metrics exporter's thread and by the scoring daemon's admission
  controller (serve/daemon.py);
- ``obs.recorder``: the per-iteration run recorder and the versioned
  run report (``tpu_run_report``);
- ``obs.profiler``: the torch.profiler window over training iterations
  (``tpu_profile_dir``/``tpu_profile_iters``);
- ``obs.export``: the live metrics exporter, ``<base>.prom`` and
  ``<base>.jsonl`` snapshots and ``GET /metrics``, ``/metrics.json``,
  ``/healthz``, ``/slo`` (``tpu_metrics_export``/``tpu_metrics_port``);
- ``obs.flight``: the always-on flight recorder and its postmortem
  bundles (``tpu_flight_buffer``/``tpu_flight_dir``).

Left out until ROADMAP item 19 (distributed): ``obs/clusterobs.py`` and
``obs/incident.py``, the cluster rollups and the many-rank incident
bundles.
"""
from . import export, flight, identity, profiler, recorder, registry
from . import reqlog, slo, trace

__all__ = ["export", "flight", "identity", "profiler", "recorder",
           "registry", "reqlog", "slo", "trace"]
