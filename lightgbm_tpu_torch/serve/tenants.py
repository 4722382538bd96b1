"""Multi-tenant model management with versioned warm atomic swap.

The JAX package's ``serve/tenants.py``. One serving process hosts N
tenants (the LRB fleet shape: many same-geometry sliding-window models,
one per traffic slice), all on the registry's device. Each tenant is a
(booster handle, version) pair published atomically under one lock:

- ``register`` loads the model text on the device, runs
  ``GBDT.prepare_serving`` (the forest's compact tables on the device
  and one warm-up predict through the forest kernel) OFF the serving
  path, and only then publishes the new handle — in-flight requests
  finish on the old model, the first request after publish finds its
  tables built (the lrb.py ``_publish`` discipline, now per tenant).
- Where the JAX package's same-geometry tenants share one compiled
  program through its predict registry, the port's have nothing to
  share: K4 is one kernel built once per process that takes any model
  geometry at launch. Each published model builds its own stack, once
  (``predict_cache/stacks``, ops/predict_cache.py).

Tenant names are restricted to ``[a-z0-9_]`` so the per-tenant metric
families (``fleet/tenant_latency_s/<t>``) stay legal Prometheus series
names.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from ..analysis import lockorder
from ..obs import registry as obs
from ..utils import log
from ..utils.device import resolve_device

# serve-bucket floor (ops/predict_cache.SERVE_MIN_BUCKET): one
# floor-width warm-up batch is the launch every 1..16-row request rides
_DEFAULT_WARM_ROWS = 16

_NAME_RE = re.compile(r"^[a-z0-9_]{1,64}$")


class _Tenant:
    __slots__ = ("name", "handle", "version")

    def __init__(self, name: str, handle, version: int):
        self.name = name
        self.handle = handle
        self.version = version


class TenantRegistry:
    """name -> (booster handle, version), swap-safe. ``device``: where
    every tenant's model loads and scores (None: ``cuda:0``, resolved
    at each registration, so a registry built without a card raises at
    its first registration)."""

    def __init__(self, warm_rows: int = _DEFAULT_WARM_ROWS, device=None):
        self.warm_rows = int(warm_rows)
        self.device = device
        self._lock = lockorder.named_lock("serve.tenants._lock")
        self._tenants: Dict[str, _Tenant] = {}   # guarded-by: _lock

    @staticmethod
    def validate_name(name: str) -> str:
        name = str(name)
        if not _NAME_RE.match(name):
            raise ValueError(
                f"tenant name {name!r} invalid: want 1-64 chars of "
                f"[a-z0-9_] (it names metric series)")
        return name

    def register(self, name: str, model_str: str,
                 warm_rows: Optional[int] = None) -> int:
        """Load + warm a model for ``name`` and publish it atomically;
        returns the published version (1 on first registration). The
        expensive half (model parse, forest stack, warm-up launch) runs
        OUTSIDE the lock — readers keep serving the old version until
        the single-assignment publish."""
        name = self.validate_name(name)
        from .. import capi
        handle = capi.LGBM_BoosterLoadModelFromString(
            str(model_str), device=resolve_device(self.device))
        wr = self.warm_rows if warm_rows is None else int(warm_rows)
        handle.gbdt.prepare_serving(warm_rows=max(wr, 0))
        with self._lock:
            old = self._tenants.get(name)
            version = (old.version + 1) if old is not None else 1
            self._tenants[name] = _Tenant(name, handle, version)
            active = len(self._tenants)
        if old is not None:
            obs.counter("fleet/model_swaps").add(1)
        obs.gauge("fleet/tenants_active").set(float(active))
        log.info("fleet tenant %r: published version %d (warm_rows=%d)",
                 name, version, wr)
        return version

    def get(self, name: str) -> Tuple[object, int]:
        """Snapshot (handle, version) for ``name``; raises KeyError for
        an unknown tenant. The returned pair stays consistent even if a
        swap publishes right after — that is the whole contract."""
        with self._lock:
            t = self._tenants.get(name)
            if t is None:
                raise KeyError(name)
            return t.handle, t.version

    def drop(self, name: str) -> bool:
        with self._lock:
            gone = self._tenants.pop(name, None) is not None
            active = len(self._tenants)
        if gone:
            obs.gauge("fleet/tenants_active").set(float(active))
        return gone

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._tenants)

    def stats(self) -> Dict:
        with self._lock:
            tenants = {n: {"version": t.version}
                       for n, t in self._tenants.items()}
        return {
            "tenants": tenants,
            "active": len(tenants),
            "model_swaps": obs.counter("fleet/model_swaps").value,
        }
