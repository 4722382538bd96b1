"""Observability of the port (the JAX package's ``obs/``, the parts the
LRB loop calls; standard library only):

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
  the scoring daemon's admission controller (serve/daemon.py).

The exporter and flight recorder (``obs/export.py``, ``flight.py``) are
ROADMAP item 20.
"""
