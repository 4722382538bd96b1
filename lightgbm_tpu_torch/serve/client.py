"""The fleet daemon's wire client: stdlib urllib + the one retry
policy (the JAX package's ``serve/client.py``).

Scoring requests are idempotent (pure reads against a published model
version), so every transient socket failure — the daemon dropping a
connection mid model-swap ("Remote end closed connection", "Connection
reset"), a not-yet-rebound listener ("Connection refused"), an overdue
response ("Read timed out" / ``socket.timeout``) — is absorbed by
utils/retry.py's bounded backoff, with the attempts/retries/giveups
visible in the ``retry/*`` counters. Admission refusals are NOT
transient: a 429 means the daemon is protecting that tenant's error
budget, and hammering through it would defeat the point — the client
surfaces ``ShedError`` (with the server's ``Retry-After``) instead of
retrying. A 503 (bounded queue full) IS retried: backpressure asks
for exactly that.

Floats survive the JSON wire bit-exactly: Python serializes float64
with shortest-round-trip repr, so the parity tests can assert
coalesced-over-HTTP == direct in-process predict to the last bit.

The JAX package's ``retry.is_transient`` matches the stdlib's socket
phrases among its device runtime's status strings; the port's matches
no strings (utils/retry.py), so the phrases of a dropped or overdue
daemon socket live here (``_WIRE_MARKERS``) and the classification is
the same.
"""
from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Dict, Optional

import numpy as np

from ..utils import retry

# the stdlib's phrases for a daemon socket dropped mid model-swap or
# mid-restart, a listener not yet bound, or a response overdue
# (http.client.RemoteDisconnected, socket.timeout through urllib)
_WIRE_MARKERS = (
    "Connection reset",
    "Connection refused",
    "Socket closed",
    "Remote end closed connection",
    "Read timed out",
)


def _transient(exc: BaseException) -> bool:
    return retry.is_transient(exc) or any(m in str(exc)
                                          for m in _WIRE_MARKERS)


class ShedError(RuntimeError):
    """HTTP 429: the tenant's error budget is burning; the daemon
    refused the request pre-breach. Not retried — honor
    ``retry_after_s``."""

    def __init__(self, tenant: str, retry_after_s: float = 1.0):
        super().__init__(
            f"tenant {tenant!r} shed by admission control "
            f"(retry after {retry_after_s:g}s)")
        self.tenant = str(tenant)
        self.retry_after_s = float(retry_after_s)


def _classify(exc: BaseException) -> bool:
    """The client's transient test: retry.is_transient and the wire's
    socket phrases, plus the HTTP status semantics of the daemon (503 =
    backpressure, retry; 429 = admission, do NOT; 4xx = caller bug,
    fail fast)."""
    if isinstance(exc, ShedError):
        return False
    if isinstance(exc, urllib.error.HTTPError):
        return exc.code in (502, 503)
    if isinstance(exc, urllib.error.URLError):
        r = exc.reason
        if isinstance(r, BaseException) and _transient(r):
            return True
    return _transient(exc)


class FleetClient:
    """Talk to one ScoringDaemon (``base_url`` from
    ``ScoringDaemon.url`` or an operator-configured endpoint)."""

    def __init__(self, base_url: str, timeout_s: float = 30.0,
                 policy: Optional[retry.RetryPolicy] = None):
        self.base_url = str(base_url).rstrip("/")
        self.timeout_s = float(timeout_s)
        self.policy = policy or retry.DEFAULT_POLICY

    # -- wire primitives -----------------------------------------------------

    def _request(self, method: str, path: str,
                 payload: Optional[dict] = None, what: str = "fleet",
                 retried: bool = True) -> dict:
        url = self.base_url + path
        data = (json.dumps(payload).encode()
                if payload is not None else None)

        def once() -> dict:
            req = urllib.request.Request(
                url, data=data, method=method,
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(
                        req, timeout=self.timeout_s) as resp:
                    return json.loads(resp.read().decode())
            except urllib.error.HTTPError as e:
                body = e.read().decode(errors="replace")
                if e.code == 429:
                    ra = float(e.headers.get("Retry-After", 1.0) or 1.0)
                    tenant = path.rsplit("/", 1)[-1]
                    raise ShedError(tenant, ra) from None
                try:
                    detail = json.loads(body).get("error", body)
                except (ValueError, AttributeError):
                    detail = body
                # re-raise carrying the body; _classify keeps 502/503
                # retryable off the original exception's status code
                e.msg = f"{e.msg}: {detail}"
                raise

        if not retried:
            return once()
        return retry.call(once, what=what, policy=self.policy,
                          classify=_classify)

    # -- API -----------------------------------------------------------------

    def predict(self, tenant: str, X) -> np.ndarray:
        return self.predict_versioned(tenant, X)[0]

    def predict_versioned(self, tenant: str, X):
        """-> (predictions ndarray, served model version). Retries
        transient failures (idempotent); raises ShedError on 429."""
        X = np.asarray(X, dtype=np.float64)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        out = self._request(
            "POST", f"/v1/predict/{tenant}",
            {"rows": X.tolist()}, what="fleet/predict")
        return (np.asarray(out["predictions"], dtype=np.float64),
                int(out["version"]))

    def register(self, tenant: str, model_str: str,
                 warm_rows: Optional[int] = None) -> int:
        """Publish a model version for ``tenant`` (warm atomic swap on
        the daemon side); idempotent enough to retry — re-registering
        the same text just bumps the version again."""
        payload: Dict = {"model": str(model_str)}
        if warm_rows is not None:
            payload["warm_rows"] = int(warm_rows)
        out = self._request("POST", f"/v1/tenants/{tenant}", payload,
                            what="fleet/register")
        return int(out["version"])

    def tenants(self) -> dict:
        return self._request("GET", "/v1/tenants", what="fleet/tenants")

    def health(self) -> dict:
        return self._request("GET", "/healthz", what="fleet/health",
                             retried=False)

    def slo(self) -> dict:
        return self._request("GET", "/slo", what="fleet/slo")
