"""The cross-request coalescer: many small requests, one device batch.

The JAX package's ``serve/coalescer.py``. N concurrent clients each
sending 1..few-row predict requests would naively pay N predict calls
(N host->device uploads, N forest-kernel launches, N readbacks) per
round. Here they queue into one bounded buffer instead, and a single
dispatcher thread drains the buffer once per *tick*:

    submit(tenant, X) ──┐
    submit(tenant, X) ──┤  bounded queue      dispatcher tick:
    submit(tenant, X) ──┼──────────────────►  linger <= max_wait
         ...            │  (<= max_queue      drain <= max_batch rows
    submit(tenant, X) ──┘   requests)         group by tenant
                                              concat -> ONE predict
                                              slice -> resolve futures

The concatenated batch rides the usual serving path — the same
``LGBM_BoosterPredictForMat`` call a direct client makes, padded to a
pow2 serve bucket (ops/predict_cache.serve_bucket_rows) — so a burst of
1-row requests from K clients costs one K4 launch per 262,144-row
chunk instead of K. Bit-exactness is free: the forest kernel scores
each row on its own, in the model's tree order, so concat + slice
returns exactly the bytes each request would have gotten alone. That
holds across the binning route too: a batch whose rows are not all
f32-exact is binned on the host, a request whose rows are is binned on
the device alone, and both give the same codes
(tests/test_torch_fleet.py asserts this for binary/multiclass/1-row/odd
batch shapes and a mixed batch).

Backpressure is explicit: a full queue refuses the submission
(``QueueFull`` -> HTTP 503 + Retry-After at the daemon) rather than
growing without bound. The tick knobs (``tpu_fleet_coalesce_us``,
``tpu_fleet_max_batch``, ``tpu_fleet_queue``) trade p50 latency for
batch width.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional

import numpy as np

from ..analysis import lockorder
from ..obs import registry as obs
from ..obs import reqlog
from ..utils import faults

from .tenants import TenantRegistry


# coalesced-batch-width histogram buckets: powers of two, matching the
# serve-bucket ladder the batches actually dispatch on (the default
# seconds-grade buckets would overflow at 60 "rows")
ROW_BUCKETS = tuple(float(1 << k) for k in range(15))   # 1 .. 16384


class QueueFull(RuntimeError):
    """The bounded admission queue refused a submission; retry after
    ``retry_after_s`` (the daemon surfaces this as HTTP 503)."""

    def __init__(self, depth: int, retry_after_s: float = 0.05):
        super().__init__(
            f"coalescer queue full ({depth} requests queued)")
        self.retry_after_s = float(retry_after_s)


class _Slot:
    __slots__ = ("tenant", "X", "rows", "future", "t_enqueue")

    def __init__(self, tenant: str, X: np.ndarray, t_enqueue: float):
        self.tenant = tenant
        self.X = X
        self.rows = int(X.shape[0])
        self.future: "Future" = Future()
        self.t_enqueue = t_enqueue


def _default_predict(handle, X: np.ndarray) -> np.ndarray:
    # the same call a direct (uncoalesced) client would make — parity
    # by construction, not by reimplementation
    from .. import capi
    return capi.LGBM_BoosterPredictForMat(
        handle, X, predict_type=capi.C_API_PREDICT_NORMAL)


class Coalescer:
    """Bounded request buffer + dispatcher thread (one per daemon)."""

    def __init__(self, tenants: TenantRegistry,
                 max_wait_us: int = 2000, max_batch: int = 4096,
                 max_queue: int = 1024,
                 predict_fn: Optional[Callable] = None,
                 latency_observer: Optional[Callable] = None,
                 clock: Callable[[], float] = time.perf_counter):
        self._tenants = tenants
        # seconds, read at enqueue, dispatch and completion: a request's
        # latency is completion minus enqueue (a test may drive it)
        self._clock = clock
        self._wait_s = max(int(max_wait_us), 0) / 1e6
        self._max_batch = max(int(max_batch), 1)
        self._max_queue = max(int(max_queue), 1)
        self._predict = predict_fn or _default_predict
        # daemon hook: per-request (tenant, latency_s) into the
        # admission controller's per-tenant histograms
        self._observe_latency = latency_observer
        self._cond = threading.Condition(
            lockorder.named_lock("serve.coalescer._cond"))
        self._q: "deque[_Slot]" = deque()     # guarded-by: _cond
        self._stop = False                    # guarded-by: _cond
        self._thread: Optional[threading.Thread] = None

    # -- client side ---------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="fleet-coalescer", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Drain-and-exit: queued requests still dispatch; new submits
        are refused."""
        t = self._thread
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if t is not None:
            t.join(timeout=30.0)
        self._thread = None

    def submit(self, tenant: str, X) -> "Future":
        """Queue one request; the returned future resolves to
        ``(predictions, model_version)``. Raises QueueFull when the
        bounded buffer is at capacity and RuntimeError after stop()."""
        X = np.asarray(X, dtype=np.float64)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        slot = _Slot(str(tenant), X, self._clock())
        with self._cond:
            if self._stop:
                raise RuntimeError("coalescer is stopped")
            if len(self._q) >= self._max_queue:
                obs.counter("fleet/queue_rejects").add(1)
                raise QueueFull(len(self._q))
            self._q.append(slot)
            depth = len(self._q)
            self._cond.notify_all()
        obs.counter("fleet/requests_total").add(1)
        obs.gauge("fleet/queue_depth").set(float(depth))
        return slot.future

    def queue_depth(self) -> int:
        with self._cond:
            return len(self._q)

    # -- dispatcher side -----------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._q and not self._stop:
                    self._cond.wait()
                if not self._q and self._stop:
                    return
                # linger: the first request of the tick is already
                # here; give the rest of the burst max_wait to join
                # the same device batch (skip straight to drain once
                # a full batch is queued)
                if self._wait_s > 0:
                    deadline = self._clock() + self._wait_s
                    while not self._stop:
                        if (sum(s.rows for s in self._q)
                                >= self._max_batch):
                            break
                        left = deadline - self._clock()
                        if left <= 0:
                            break
                        self._cond.wait(left)
                batch = self._drain_locked()
                depth = len(self._q)
            obs.gauge("fleet/queue_depth").set(float(depth))
            self._dispatch_batch(batch)

    def _drain_locked(self) -> List[_Slot]:
        """Pop FIFO slots up to max_batch rows (always at least one —
        a single oversized request must still serve); the remainder
        stays queued for the next tick."""
        batch: List[_Slot] = []
        rows = 0
        while self._q:
            if batch and rows + self._q[0].rows > self._max_batch:
                break
            # unguarded-ok: caller holds _cond (_loop's with block)
            s = self._q.popleft()
            batch.append(s)
            rows += s.rows
        return batch

    def _dispatch_batch(self, batch: List[_Slot]) -> None:
        # group by tenant, order preserved: one concatenated predict
        # per tenant per tick
        groups: "Dict[str, List[_Slot]]" = {}
        for s in batch:
            groups.setdefault(s.tenant, []).append(s)
        for tenant, slots in groups.items():
            self._dispatch_tenant(tenant, slots)

    def _dispatch_tenant(self, tenant: str, slots: List[_Slot]) -> None:
        try:
            handle, version = self._tenants.get(tenant)
        except KeyError as e:
            for s in slots:
                s.future.set_exception(e)
            return
        rows = sum(s.rows for s in slots)
        X = (slots[0].X if len(slots) == 1
             else np.concatenate([s.X for s in slots], axis=0))
        rid = reqlog.next_request_id()
        t0 = self._clock()
        try:
            if faults.active():
                # fleet.predict / fleet.predict.<tenant>: the latency/
                # failure seam for the shed drills (utils/faults.py)
                faults.check("fleet.predict", context=tenant)
                faults.check("fleet.predict." + tenant, context=tenant)
            with reqlog.request(rid) as ctx:
                preds = self._predict(handle, X)
        except BaseException as e:        # noqa: BLE001 — each waiting
            # request gets the real error; the dispatcher must survive
            for s in slots:
                if not s.future.set_running_or_notify_cancel():
                    continue
                s.future.set_exception(e)
            return
        done = self._clock()
        off = 0
        for s in slots:
            part = preds[off:off + s.rows]
            off += s.rows
            if s.future.set_running_or_notify_cancel():
                s.future.set_result((part, version))
            lat = done - s.t_enqueue
            if self._observe_latency is not None:
                self._observe_latency(tenant, lat)
        obs.histogram("fleet/coalesced_batch_rows",
                      ROW_BUCKETS).observe(float(rows))
        obs.counter("fleet/coalesced_requests").add(len(slots))
        reqlog.record(
            "request", req_id=rid, path="fleet/serve", tenant=tenant,
            rows=rows, requests=len(slots), bucket=ctx.bucket,
            model_version=version,
            latency_ms=round((done - t0) * 1e3, 3))
