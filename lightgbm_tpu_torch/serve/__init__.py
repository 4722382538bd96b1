"""Fleet serving: the networked multi-tenant scoring front.

The JAX package's ``serve/``, on the card. The LRB workload is a
*serving* system — every cache-admission decision is a predict call
against the freshest sliding-window model. This package is the network
front that turns concurrent traffic into shared launches of the forest
kernel (K4, ``ops/forest.py``):

- ``tenants.py``  — per-tenant boosters on one device with versioned
  warm atomic swap (``prepare_serving`` + publish-on-complete);
- ``coalescer.py`` — concurrent single/small-batch requests queue into
  a bounded buffer; a dispatcher thread drains them into one device
  batch per tenant per tick and slices the results back per request —
  bit-identical to direct predict, with one predict call (and its K4
  launches) for the whole batch instead of one per request;
- ``daemon.py``   — the stdlib ``http.server`` scoring endpoint with
  SLO-driven admission control (obs/slo.py): when a tenant's p99 error
  budget burns low, that tenant is shed (429 + ``Retry-After``) BEFORE
  the breach while its neighbors keep serving;
- ``client.py``   — the stdlib urllib client; idempotent scoring
  requests retry transient socket failures under the one bounded
  backoff policy (utils/retry.py).

Everything here is stdlib + numpy + the port's obs/ops plumbing;
models load on the daemon's device (None: ``cuda:0``, raising at the
first registration when there is no card; ``"cpu"`` runs the plain
PyTorch path, as the tests do).
"""
from .client import FleetClient, ShedError
from .coalescer import Coalescer, QueueFull
from .daemon import ScoringDaemon
from .tenants import TenantRegistry

__all__ = [
    "Coalescer", "FleetClient", "QueueFull", "ScoringDaemon",
    "ShedError", "TenantRegistry",
]
