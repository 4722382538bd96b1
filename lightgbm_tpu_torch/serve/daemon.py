"""The fleet scoring daemon: a stdlib HTTP front over the coalescer.

The JAX package's ``serve/daemon.py``. One process, N tenants on one
device (``device``; None: ``cuda:0``), these routes (a
``ThreadingHTTPServer`` — stdlib only, daemon threads, bind on
127.0.0.1, port 0 = ephemeral):

    POST /v1/predict/<tenant>   {"rows": [[...], ...]}
                                -> {"predictions": [...], "version": v}
    POST /v1/tenants/<tenant>   {"model": "<model text>", "warm_rows": n}
                                -> {"tenant": t, "version": v}
    GET  /v1/tenants            registered tenants + registry stats
    GET  /healthz               liveness + queue depth + shed state
    GET  /slo                   the admission engine's budget report

Admission control runs BEFORE the queue: when ``tpu_fleet_slo_p99_ms``
is set, every registered tenant gets a
``hist:fleet/tenant_latency_s/<t>:p99 < target`` objective on a
dedicated obs/slo.py engine, and a tenant whose remaining error budget
has burned to ``tpu_fleet_shed_budget`` or below is refused with
HTTP 429 + ``Retry-After`` — shedding starts while budget remains
(before the breach), the shed tenant stops adding bad events, and its
neighbors keep serving. The state machine per tenant:

    SERVING ──(budget_remaining <= shed threshold)──► SHEDDING
    SHEDDING ──(budget recovers above threshold)────► SERVING

Recovery is possible because the shed tenant's histogram stops
accumulating slow events while shed (total grows only via the
occasional probe the operator sends), and because a model swap or
fault repair removes the latency source.

Model registration is the warm-swap path: the model is parsed, forest-
stacked and serve-bucket warmed OFF the serving path, then published
atomically — in-flight requests finish on the old version
(serve/tenants.py).

Where the port differs from the JAX daemon:

- ``device``: where every tenant's model loads and scores. With none,
  a daemon on a machine without a card starts, and its first
  registration raises (HTTP 500 over the wire): nothing is served from
  the CPU unless ``device="cpu"`` asks for it.
- ``stats()["predict_cache"]`` is the port's ``predict_cache.stats()``:
  the serve-bucket policy and the forest-stack counters (``stacks``,
  ``stacked_trees``), not the JAX registry's compiled-program hits,
  misses and evictions. The port has no compiled-program registry: K4
  is one kernel that takes any row count and model geometry at launch
  (ops/predict_cache.py says why).
- The SLO engine here is the daemon's own, evaluated by its admission
  clock as in the JAX package. ``from_params`` also arms the
  process-global metrics exporter and SLO engine from the params'
  ``tpu_metrics_export``/``tpu_metrics_port`` and ``tpu_slo`` (the JAX
  package arms them in its boosters' init): the exporter's thread is
  then the global engine's clock, and the admission engine's gauges
  ride its snapshots.
"""
from __future__ import annotations

import atexit
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from ..analysis import lockorder
from ..obs import registry as obs
from ..obs import slo as obs_slo
from ..obs.trace import config_get
from ..utils import log

from .coalescer import Coalescer, QueueFull
from .tenants import TenantRegistry


class ScoringDaemon:
    """Tenant registry + coalescer + HTTP front + admission control."""

    def __init__(self, port: int = 0, coalesce_us: int = 2000,
                 max_batch: int = 4096, max_queue: int = 1024,
                 warm_rows: int = 16, slo_p99_ms: float = 0.0,
                 shed_budget: float = 0.25,
                 slo_eval_gap_s: float = 0.05,
                 slo_min_events: int = 100,
                 shed_probe_every: int = 16,
                 retry_after_s: float = 0.5,
                 predict_timeout_s: float = 60.0, device=None,
                 clock: Callable[[], float] = time.perf_counter):
        self._port = int(port)
        self.tenants = TenantRegistry(warm_rows=warm_rows, device=device)
        self.coalescer = Coalescer(
            self.tenants, max_wait_us=coalesce_us, max_batch=max_batch,
            max_queue=max_queue, latency_observer=self._observe_latency,
            clock=clock)
        self._slo_p99_ms = max(float(slo_p99_ms), 0.0)
        self._shed_budget = min(max(float(shed_budget), 0.0), 1.0)
        self._slo_eval_gap_s = max(float(slo_eval_gap_s), 0.0)
        self._slo_min_events = max(int(slo_min_events), 0)
        self._shed_probe_every = max(int(shed_probe_every), 0)
        self._retry_after_s = max(float(retry_after_s), 0.01)
        self._predict_timeout_s = float(predict_timeout_s)
        self._lock = lockorder.named_lock("serve.daemon._lock")
        # admission engine state, all guarded-by: _lock — the engine
        # is rebuilt on tenant registration (one spec per tenant) and
        # evaluated at a bounded rate on the request path (this daemon
        # may be the only evaluation clock in the process)
        self._slo_engine: Optional[obs_slo.SloEngine] = None
        self._spec_names: Dict[str, str] = {}    # tenant -> spec name
        self._shedding: Dict[str, dict] = {}     # tenant -> shed state
        self._last_eval = 0.0
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._stopped = False

    @classmethod
    def from_config(cls, params=None, **overrides) -> "ScoringDaemon":
        """Build from the ``tpu_fleet_*`` knobs (a Config object or a
        raw params dict); explicit keyword overrides win."""
        kw = dict(
            port=int(config_get(params, "tpu_fleet_port", 0) or 0),
            coalesce_us=int(config_get(
                params, "tpu_fleet_coalesce_us", 2000)),
            max_batch=int(config_get(params, "tpu_fleet_max_batch",
                                     4096)),
            max_queue=int(config_get(params, "tpu_fleet_queue", 1024)),
            slo_p99_ms=float(config_get(params, "tpu_fleet_slo_p99_ms",
                                        0.0) or 0.0),
            shed_budget=float(config_get(
                params, "tpu_fleet_shed_budget", 0.25)),
        )
        kw.update(overrides)
        from ..obs import export as obs_export
        obs_slo.ensure_from_config(params)
        obs_export.ensure_from_config(params)
        return cls(**kw)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ScoringDaemon":
        if self._server is not None:
            return self
        self.coalescer.start()
        daemon = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):   # noqa: N802 — http.server
                pass                        # API; obs logging instead

            def do_GET(self):               # noqa: N802
                daemon._handle_get(self)

            def do_POST(self):              # noqa: N802
                daemon._handle_post(self)

        class Server(ThreadingHTTPServer):
            # http.server's default accept backlog is 5: a fleet of
            # clients opening one TCP connection per request overflows
            # it under burst load, and the resulting resets surface as
            # client-side retry/backoff latency spikes
            request_queue_size = 128

        try:
            self._server = Server(
                ("127.0.0.1", max(self._port, 0)), Handler)
        except OSError as e:
            # degrade, don't die: the embedding run (lrb
            # --serve-daemon) falls back to in-process scoring
            self.coalescer.stop()
            raise RuntimeError(
                f"fleet daemon could not bind port {self._port}: {e}")
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="fleet-daemon",
            daemon=True)
        self._thread.start()
        atexit.register(self.stop)
        log.info("fleet scoring daemon listening on 127.0.0.1:%d",
                 self.http_port)
        return self

    def stop(self) -> None:
        """Idempotent clean shutdown: close the listener, then drain
        the coalescer (queued requests still complete)."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
        srv, thr = self._server, self._thread
        self._server = None
        self._thread = None
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        if thr is not None:
            thr.join(timeout=10.0)
        self.coalescer.stop()

    @property
    def http_port(self) -> int:
        """The bound port (resolves port=0 ephemeral binds)."""
        srv = self._server
        return int(srv.server_address[1]) if srv is not None \
            else self._port

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.http_port}"

    # -- serving primitives (also the in-process API) ------------------------

    def register_tenant(self, name: str, model_str: str,
                        warm_rows: Optional[int] = None) -> int:
        version = self.tenants.register(name, model_str,
                                        warm_rows=warm_rows)
        self._rebuild_slo()
        return version

    def predict(self, tenant: str, X, timeout_s: Optional[float] = None):
        """Admission check + coalesced predict; returns
        ``(predictions, version)``. Raises ShedError/QueueFull/KeyError
        exactly as the HTTP front maps them (429/503/404)."""
        retry_after = self.shed_check(tenant)
        if retry_after is not None:
            from .client import ShedError
            raise ShedError(tenant, retry_after)
        fut = self.coalescer.submit(tenant, X)
        return fut.result(timeout=(self._predict_timeout_s
                                   if timeout_s is None else timeout_s))

    # -- admission control ---------------------------------------------------

    def _observe_latency(self, tenant: str, latency_s: float) -> None:
        # bounded-cardinality: one series per registered tenant —
        # tenant names are operator-supplied registrations (validated
        # [a-z0-9_]), not request-derived
        obs.latency_histogram(
            "fleet/tenant_latency_s/" + tenant).observe(latency_s)

    def _rebuild_slo(self) -> None:
        if self._slo_p99_ms <= 0:
            return
        thr_s = self._slo_p99_ms / 1e3
        specs, names = [], {}
        for t in self.tenants.names():
            # create the instrument FIRST with the quantile-grade
            # latency buckets — otherwise the engine's first evaluate
            # would get-or-create it with the coarse default bounds
            # bounded-cardinality: one series per registered tenant
            obs.latency_histogram("fleet/tenant_latency_s/" + t)
            text = f"hist:fleet/tenant_latency_s/{t}:p99 < {thr_s:g}"
            spec = obs_slo.parse_specs(text)[0]
            names[t] = spec.name
            specs.append(spec)
        with self._lock:
            self._slo_engine = obs_slo.SloEngine(
                specs, min_events=self._slo_min_events)
            self._spec_names = names

    def shed_check(self, tenant: str) -> Optional[float]:
        """None = admit; a float = shed, retry after that many
        seconds. Evaluates the admission engine at a bounded rate —
        the daemon is its own SLO clock, so a tenant is shed as soon
        as its burn shows, between requests."""
        with self._lock:
            engine = self._slo_engine
            spec_name = self._spec_names.get(tenant)
            if engine is None or spec_name is None:
                return None
            now = time.monotonic()
            fresh = (now - self._last_eval) >= self._slo_eval_gap_s
            if fresh:
                self._last_eval = now
        report = engine.report(fresh=fresh)
        row = next((r for r in report.get("specs", [])
                    if r["name"] == spec_name), None)
        if row is None:
            return None
        remaining = row["budget_remaining"]
        shed = (remaining <= self._shed_budget
                and not row.get("warming", False))
        with self._lock:
            state = self._shedding.get(tenant)
            if shed and state is None:
                # entering SHEDDING: snapshot the budget at first shed
                # — the drill's proof that admission acted pre-breach
                state = self._shedding[tenant] = {
                    "since": round(time.time(), 3),
                    "budget_remaining_at_shed": remaining,
                    "exhausted_at_shed": bool(row["exhausted"]),
                    "sheds": 0,
                }
                log.warning(
                    "fleet tenant %r SHED: p99 budget remaining %.3f "
                    "<= %.3f threshold (burn %.2f)", tenant, remaining,
                    self._shed_budget, row["burn_rate"])
            elif not shed and state is not None:
                del self._shedding[tenant]
                log.info("fleet tenant %r recovered: budget %.3f",
                         tenant, remaining)
            if shed:
                state["sheds"] += 1
                if (self._shed_probe_every
                        and state["sheds"] % self._shed_probe_every
                        == 0):
                    # probe trickle: admit 1 in N while shedding — a
                    # cumulative budget can only recover through new
                    # events, and a fully-shed tenant would otherwise
                    # starve its own histogram and stay shed forever
                    return None
        if not shed:
            return None
        obs.counter("fleet/shed_total").add(1)
        # bounded-cardinality: one series per registered tenant (see
        # _observe_latency)
        obs.counter("fleet/shed/" + tenant).add(1)
        return self._retry_after_s

    def slo_report(self) -> dict:
        with self._lock:
            engine = self._slo_engine
            shedding = {t: dict(s) for t, s in self._shedding.items()}
        rep = engine.report(fresh=True) if engine is not None \
            else {"specs": [], "ok": None}
        rep["shedding"] = shedding
        rep["shed_budget"] = self._shed_budget
        return rep

    def stats(self) -> dict:
        """Registry, queue and admission counters, and the serve-bucket
        and forest-stack counters (see the module docstring)."""
        from ..ops import predict_cache
        return {
            "tenants": self.tenants.stats(),
            "queue_depth": self.coalescer.queue_depth(),
            "requests_total": obs.counter("fleet/requests_total").value,
            "shed_total": obs.counter("fleet/shed_total").value,
            "queue_rejects": obs.counter("fleet/queue_rejects").value,
            "predict_cache": predict_cache.stats(),
        }

    # -- HTTP plumbing -------------------------------------------------------

    def _send_json(self, h, code: int, payload: dict,
                   headers: Optional[dict] = None) -> None:
        body = json.dumps(payload).encode()
        h.send_response(code)
        h.send_header("Content-Type", "application/json")
        h.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            h.send_header(k, v)
        h.end_headers()
        try:
            h.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass    # client went away; nothing to salvage

    def _read_json(self, h) -> dict:
        n = int(h.headers.get("Content-Length", 0) or 0)
        raw = h.rfile.read(n) if n else b""
        return json.loads(raw.decode()) if raw else {}

    def _handle_get(self, h) -> None:
        if h.path == "/healthz":
            with self._lock:
                shedding = sorted(self._shedding)
            self._send_json(h, 200, {
                "ok": True,
                "tenants": self.tenants.names(),
                "queue_depth": self.coalescer.queue_depth(),
                "shedding": shedding,
            })
        elif h.path == "/slo":
            self._send_json(h, 200, self.slo_report())
        elif h.path == "/v1/tenants":
            self._send_json(h, 200, self.stats())
        else:
            self._send_json(h, 404, {"error": f"no route {h.path}"})

    def _handle_post(self, h) -> None:
        try:
            if h.path.startswith("/v1/predict/"):
                self._handle_predict(h, h.path[len("/v1/predict/"):])
            elif h.path.startswith("/v1/tenants/"):
                self._handle_register(h, h.path[len("/v1/tenants/"):])
            else:
                self._send_json(h, 404, {"error": f"no route {h.path}"})
        except json.JSONDecodeError as e:
            self._send_json(h, 400, {"error": f"bad JSON body: {e}"})
        except ValueError as e:
            self._send_json(h, 400, {"error": str(e)})
        except Exception as e:          # noqa: BLE001 — the serving
            # thread answers with the real error instead of dying
            self._send_json(h, 500,
                            {"error": f"{type(e).__name__}: {e}"})

    def _handle_predict(self, h, tenant: str) -> None:
        body = self._read_json(h)
        rows = body.get("rows")
        if not isinstance(rows, list) or not rows:
            self._send_json(h, 400,
                            {"error": "want {\"rows\": [[...], ...]}"})
            return
        retry_after = self.shed_check(tenant)
        if retry_after is not None:
            self._send_json(
                h, 429,
                {"error": f"tenant {tenant!r} shed: p99 error budget "
                          f"low", "tenant": tenant},
                headers={"Retry-After": f"{retry_after:g}"})
            return
        try:
            fut = self.coalescer.submit(tenant, rows)
            preds, version = fut.result(
                timeout=self._predict_timeout_s)
        except QueueFull as e:
            self._send_json(
                h, 503, {"error": str(e)},
                headers={"Retry-After": f"{e.retry_after_s:g}"})
            return
        except KeyError:
            self._send_json(
                h, 404, {"error": f"unknown tenant {tenant!r}"})
            return
        self._send_json(h, 200, {
            "tenant": tenant,
            "version": version,
            "rows": len(rows),
            "predictions": preds.tolist(),
        })

    def _handle_register(self, h, tenant: str) -> None:
        body = self._read_json(h)
        model_str = body.get("model")
        if not isinstance(model_str, str) or not model_str:
            self._send_json(h, 400,
                            {"error": "want {\"model\": \"<text>\"}"})
            return
        warm = body.get("warm_rows")
        version = self.register_tenant(
            tenant, model_str,
            warm_rows=None if warm is None else int(warm))
        self._send_json(h, 200, {"tenant": tenant, "version": version})
