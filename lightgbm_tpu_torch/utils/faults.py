"""Deterministic fault injection for the fault-tolerance drills.

The JAX package's ``utils/faults.py``. Tests (and operators running
game-day drills) arm named injection points and the port's retry and
degrade machinery must absorb the blast. The points are fixed,
seed-keyed and counted, so a failing drill reproduces exactly: the same
occurrence of the same point fails on every run with the same spec.

The port wires these points (grep ``faults.check``):
``train.iter``, the top of each boosting iteration of ``engine.train``
and the CLI driver (``GBDT.train``; the kill-and-resume drills aim
here); ``checkpoint.write``, a checkpoint bundle's serialization
(utils/checkpoint.py); ``export.write``, a metrics exporter snapshot
(obs/export.py); ``lrb.window_train``, one sliding window's training in
the LRB loop (lrb.py, the degrade-don't-die path); and ``fleet.predict``
/ ``fleet.predict.<tenant>``, one coalesced dispatch of the scoring
daemon (serve/coalescer.py, the latency seam of the shed drills). The
JAX package's ingest points wait for its ingest retry path.

Spec grammar (``configure(spec)`` / the ``tpu_faults`` config knob /
the ``LGBM_TPU_FAULTS`` env var for subprocess drills)::

    point@N[,N...][:action] [; more points]

    train.iter@17:kill            SIGKILL self on the 17th iteration
    lrb.window_train@2            raise a persistent fault on call 2
    lrb.window_train@1:transient  raise a RETRYABLE fault on call 1
    lrb.window_train@1:kill       SIGKILL self on call 1
    lrb.window_train@p0.25        seeded coin-flip per call (p=0.25)

Occurrences are 1-based per point and counted process-wide; ``N+``
means "every call from the N-th on". Actions: ``raise`` (default, a
persistent ``InjectedFault``), ``transient`` (an
``InjectedFault(transient=True)``, which utils/retry.py classifies as
retryable), ``kill`` (``SIGKILL`` to self, the crash drills), and
``sleep<ms>`` (e.g. ``sleep50``: stall the call for that many
milliseconds and then RETURN normally, a pure latency fault).

Every fired rule but ``sleep`` triggers the flight recorder
(obs/flight.py) before the blast: a ``kill`` SIGKILLs the process, so
the bundle written just before it is the only evidence there will be.

Stdlib + obs only.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, Optional

from . import log

ENV_SPEC = "LGBM_TPU_FAULTS"
ENV_SEED = "LGBM_TPU_FAULTS_SEED"

KNOWN_ACTIONS = ("raise", "transient", "kill")


class InjectedFault(RuntimeError):
    """A deliberately injected failure. ``transient`` marks it
    retryable for utils/retry.py's classifier."""

    def __init__(self, msg: str, transient: bool = False):
        super().__init__(msg)
        self.transient = transient


class _Rule:
    """One point's firing rule: explicit occurrence set, an open-ended
    threshold (``N+``), or a seeded per-call probability. Each p-rule
    owns a PRIVATE RNG seeded from (seed, point): a shared stream
    consumed in cross-thread call-arrival order would make multi-point
    probability drills non-reproducible — the one property the seed
    exists to provide."""

    def __init__(self, at=(), at_from: Optional[int] = None,
                 p: Optional[float] = None, action: str = "raise",
                 seed: int = 0, point: str = "", sleep_ms: float = 0.0):
        self.at = frozenset(int(x) for x in at)
        self.at_from = at_from
        self.p = p
        self.action = action
        self.sleep_ms = float(sleep_ms)
        if p is not None:
            import random
            self.rng = random.Random(f"{seed}:{point}")

    def fires(self, count: int, coin: float) -> bool:
        if count in self.at:
            return True
        if self.at_from is not None and count >= self.at_from:
            return True
        if self.p is not None and coin < self.p:
            return True
        return False


_lock = threading.Lock()
_rules: Dict[str, _Rule] = {}
_counts: Dict[str, int] = {}
_env_loaded = False
_armed_spec = None              # (spec, seed) for idempotent re-arming


def _parse_spec(spec: str, seed: int) -> Dict[str, _Rule]:
    rules: Dict[str, _Rule] = {}
    for part in str(spec).split(";"):
        part = part.strip()
        if not part:
            continue
        if "@" not in part:
            raise ValueError(f"fault spec {part!r}: want point@N[:action]")
        point, rest = part.split("@", 1)
        action, sleep_ms = "raise", 0.0
        if ":" in rest:
            rest, action = rest.rsplit(":", 1)
            action = action.strip().lower()
            if action.startswith("sleep"):
                try:
                    sleep_ms = float(action[len("sleep"):] or "nan")
                except ValueError:
                    sleep_ms = float("nan")
                if not sleep_ms >= 0.0:       # catches NaN too
                    raise ValueError(
                        f"fault spec {part!r}: want sleep<ms> with a "
                        f"non-negative millisecond count (e.g. sleep50)")
                action = "sleep"
            elif action not in KNOWN_ACTIONS:
                raise ValueError(
                    f"fault spec {part!r}: unknown action {action!r} "
                    f"(want sleep<ms> or one of "
                    f"{'/'.join(KNOWN_ACTIONS)})")
        rest = rest.strip()
        at, at_from, p = [], None, None
        if rest.startswith("p"):
            p = float(rest[1:])
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"fault spec {part!r}: probability "
                                 f"{p} outside [0, 1]")
        else:
            for tok in rest.split(","):
                tok = tok.strip()
                if tok.endswith("+"):
                    at_from = int(tok[:-1])
                elif tok:
                    at.append(int(tok))
        name = point.strip()
        rules[name] = _Rule(at, at_from, p, action, seed=seed,
                            point=name, sleep_ms=sleep_ms)
    return rules


def configure(spec, seed: int = 0) -> None:
    """Arm injection points from a spec string (see module docstring)
    or a ``{point: rule-kwargs}`` dict. Replaces the current plan and
    resets occurrence counts — EXCEPT when re-arming the identical
    (spec, seed), which is a no-op so a driver that arms from config
    cannot reset a drill's occurrence counters mid-run. Empty/None
    disarms."""
    global _armed_spec
    if isinstance(spec, dict):
        rules = {str(k): _Rule(point=str(k), seed=seed, **v)
                 for k, v in spec.items()}
    elif spec:
        if _armed_spec == (spec, seed):
            return
        rules = _parse_spec(spec, seed)
    else:
        rules = {}
    _armed_spec = (spec, seed) if spec and not isinstance(spec, dict) \
        else None
    with _lock:
        _rules.clear()
        _rules.update(rules)
        _counts.clear()
    if rules:
        log.warning("fault injection ARMED: %s",
                    ", ".join(sorted(rules)))


def configure_from_config(config) -> None:
    """Arm from the ``tpu_faults`` config knob (idempotent no-op when
    the knob is empty: a plan armed by a test or the environment stays
    armed)."""
    spec = str(getattr(config, "tpu_faults", "") or "")
    if spec:
        configure(spec, int(getattr(config, "tpu_fault_seed", 0) or 0))


def clear() -> None:
    configure(None)


def _ensure_env_loaded() -> None:
    """Lazy one-shot env arm: subprocess drills export
    ``LGBM_TPU_FAULTS`` and the child needs no code changes."""
    global _env_loaded
    if _env_loaded:
        return
    _env_loaded = True
    spec = os.environ.get(ENV_SPEC, "")
    if spec:
        configure(spec, int(os.environ.get(ENV_SEED, "0") or 0))


def active() -> bool:
    """True when any point is armed (hot paths gate on this)."""
    _ensure_env_loaded()
    return bool(_rules)


def check(point: str, context=None) -> None:
    """Count one call of ``point`` and inject its armed action if the
    rule fires. No-op (one dict lookup) when nothing is armed."""
    _ensure_env_loaded()
    if not _rules:
        return
    with _lock:
        rule = _rules.get(point)
        if rule is None:
            return
        _counts[point] = count = _counts.get(point, 0) + 1
        # per-point RNG: the coin for a point's Nth call is a pure
        # function of (seed, point, N) regardless of what other
        # points' threads are doing
        coin = rule.rng.random() if rule.p is not None else 1.0
        fire = rule.fires(count, coin)
    if not fire:
        return
    from ..obs import registry as obs
    obs.counter("faults/injected").add(1)
    ctx = f" ({context})" if context is not None else ""
    msg = (f"injected fault at {point} occurrence {count}{ctx} "
           f"[action={rule.action}]")
    log.warning("%s", msg)
    if rule.action == "sleep":
        # latency fault: stall, then let the call proceed — the caller
        # never sees an exception, only the wall-clock damage
        import time
        time.sleep(rule.sleep_ms / 1000.0)
        return
    # black box BEFORE the blast: a kill action SIGKILLs the process —
    # this dump is the only evidence that will ever exist for it
    # (forced: the moment cannot recur; obs/flight.py)
    from ..obs import flight
    flight.trigger("fault", {"point": point, "occurrence": count,
                             "action": rule.action,
                             **({"context": str(context)}
                                if context is not None else {})},
                   force=rule.action == "kill")
    if rule.action == "kill":
        import signal
        os.kill(os.getpid(), signal.SIGKILL)
    raise InjectedFault(msg, transient=rule.action == "transient")


def counts() -> Dict[str, int]:
    """Per-point call counts so far (tests)."""
    with _lock:
        return dict(_counts)
