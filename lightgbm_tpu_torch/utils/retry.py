"""Bounded retry with exponential backoff + jitter for transient
failures.

The JAX package's ``utils/retry.py``: the one policy for absorbing
failures that succeed moments later. Retry with exponential backoff and
deterministic jitter, give up after a bounded number of attempts, and
count every decision in the obs registry (``retry/attempts``,
``retry/retries``, ``retry/giveups``).

Classification is conservative: only errors that *say* they are
transient are retried (stdlib connection errors and timeouts, and an
injected ``InjectedFault(transient=True)`` from utils/faults.py); a
genuine bug, a CUDA error among them, fails fast on attempt 1. The JAX
package also retries on the status strings of its device runtime's RPC
(``RESOURCE_EXHAUSTED``, ...); the port talks to its card through no
RPC, so it has no such strings to match.

Stdlib + obs only.
"""
from __future__ import annotations

import random
import time
from typing import Callable, Optional

from . import log
from .faults import InjectedFault


def is_transient(exc: BaseException) -> bool:
    """True when ``exc`` is worth retrying (see module docstring)."""
    if isinstance(exc, InjectedFault):
        return bool(exc.transient)
    return isinstance(exc, (ConnectionError, TimeoutError))


class RetryPolicy:
    """Backoff shape: ``attempts`` total tries, delay
    ``base_s * 2**k`` capped at ``max_s``, plus up to ``jitter`` of
    that delay from a seeded RNG (deterministic for a given seed —
    drills reproduce; production leaves seed=None for wall-clock
    entropy)."""

    def __init__(self, attempts: int = 4, base_s: float = 0.05,
                 max_s: float = 2.0, jitter: float = 0.5,
                 seed: Optional[int] = None,
                 sleep: Callable[[float], None] = time.sleep):
        self.attempts = max(int(attempts), 1)
        self.base_s = max(float(base_s), 0.0)
        self.max_s = max(float(max_s), self.base_s)
        self.jitter = max(float(jitter), 0.0)
        self._rng = random.Random(seed)
        self._sleep = sleep

    def delay_s(self, retry_index: int) -> float:
        """Backoff before retry ``retry_index`` (0-based)."""
        d = min(self.base_s * (2.0 ** retry_index), self.max_s)
        return d * (1.0 + self.jitter * self._rng.random())

    def sleep(self, retry_index: int) -> float:
        d = self.delay_s(retry_index)
        if d > 0:
            self._sleep(d)
        return d


DEFAULT_POLICY = RetryPolicy()


def call(fn: Callable, *, what: str = "operation",
         policy: Optional[RetryPolicy] = None,
         classify: Callable[[BaseException], bool] = is_transient):
    """Run ``fn()``; retry transient failures per ``policy``. The final
    transient failure (or any non-transient one) re-raises unchanged —
    callers see the real error, plus a ``gave up`` log line carrying
    ``what`` and the attempt count. ``classify`` decides what is
    transient (the fleet client passes its HTTP status rules,
    serve/client.py)."""
    from ..obs import registry as obs
    p = policy or DEFAULT_POLICY
    for attempt in range(1, p.attempts + 1):
        obs.counter("retry/attempts").add(1)
        try:
            return fn()
        except BaseException as e:      # noqa: BLE001 — classified below
            if not classify(e):
                raise
            if attempt >= p.attempts:
                obs.counter("retry/giveups").add(1)
                log.warning("%s: gave up after %d attempts (%s: %s)",
                            what, attempt, type(e).__name__, e)
                raise
            obs.counter("retry/retries").add(1)
            d = p.sleep(attempt - 1)
            log.warning("%s: transient failure (attempt %d/%d, retrying "
                        "in %.2fs): %s", what, attempt, p.attempts, d, e)
