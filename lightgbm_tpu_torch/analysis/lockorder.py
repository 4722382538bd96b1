"""Runtime lock-order detector: "no deadlock yet" becomes a checked
property.

The JAX package's ``analysis/lockorder.py``, copied for the port (which
imports nothing of that package). Deadlock is an ORDER property -- thread
1 takes A then B while thread 2 takes B then A -- that only shows up when
real threads interleave. The LRB loop's trainer and server threads
(lrb.py) give the interleavings; this module records the lock
**acquisition graph** while they run and fails on cycles.

Design (production pays nothing):

- ``named_lock(name)`` / ``named_rlock(name)`` are the factories the
  port's long-lived locks are created through. With detection OFF
  (the default) they return a plain ``threading.Lock``/``RLock``:
  zero wrapper, zero per-acquire cost.
- With detection ON (``detecting()`` context manager, or the
  ``LGBM_TPU_LOCK_ORDER=1`` env var at import), they return a
  ``_TrackedLock`` proxy that delegates to a real lock and tells the
  monitor about acquire/release. Module-level locks created at import
  time are swapped in-place for the detection window via a patch
  table (``GLOBAL_LOCKS``): the proxy wraps the ORIGINAL lock
  object, so mutual exclusion is untouched; only visibility changes.
- The monitor keeps, per thread, the set of currently-held named
  locks; acquiring ``b`` while holding ``a`` adds the edge ``a -> b``
  (with one sample code location per new edge). Reentrant RLock
  acquires don't re-push. ``cycles()`` runs a DFS over the name
  graph; the liveness tests assert it returns nothing.

Lock names are CLASSES of locks (every ``GBDT._stacked_lock`` shares
one node): a cycle between name classes is exactly the two-booster /
two-subsystem deadlock shape. A same-name edge (two INSTANCES of one
class held together) shows up as a self-cycle.
"""
from __future__ import annotations

import os
import threading
import traceback
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

__all__ = ["named_lock", "named_rlock", "detecting", "Monitor",
           "LockOrderError", "GLOBAL_LOCKS"]


class LockOrderError(AssertionError):
    """A cycle in the lock-acquisition graph."""


# locks created at import time, swapped for the detection window:
# (module dotted path, attribute path, lock-class name). A dotted
# attribute path reaches INSTANCE locks of import-time singletons
# (the default metrics registry) — the proxy wraps the ORIGINAL lock
# object, so children holding raw references stay mutually exclusive
# with the patched accessor (their acquisitions are just not seen).
GLOBAL_LOCKS: Tuple[Tuple[str, str, str], ...] = (
    ("lightgbm_tpu_torch.utils.log", "_lock", "log._lock"),
    ("lightgbm_tpu_torch.utils.faults", "_lock", "faults._lock"),
    ("lightgbm_tpu_torch.obs.registry", "_default._lock",
     "obs.registry._lock"),
    ("lightgbm_tpu_torch.obs.reqlog", "_id_lock", "reqlog._id_lock"),
    ("lightgbm_tpu_torch.obs.reqlog", "_global_lock",
     "reqlog._global_lock"),
)


class Monitor:
    """The acquisition-graph recorder. All internal state is guarded
    by a RAW lock (never a tracked one — the monitor must not observe
    itself)."""

    def __init__(self):
        # REENTRANT: a signal handler can fire while the interrupted
        # thread is inside on_acquired holding this lock and re-enter
        # the monitor; a plain Lock would self-deadlock the process.
        # Worst case under reentrancy is a torn edge COUNT, never a
        # hang.
        self._mu = threading.RLock()
        # (from_name, to_name) -> [count, sample "file:line (thread)"]
        self._edges: Dict[Tuple[str, str], list] = {}
        self._names: Dict[str, int] = {}      # name -> acquire count
        self._tls = threading.local()

    # -- hooks ---------------------------------------------------------------

    def _held(self) -> Dict[int, Tuple[str, int]]:
        """This thread's held locks: id(lock) -> (name, depth)."""
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = {}
        return held

    def on_acquired(self, lock_id: int, name: str) -> None:
        held = self._held()
        if lock_id in held:             # reentrant RLock acquire
            n, depth = held[lock_id]
            held[lock_id] = (n, depth + 1)
            return
        new_edges = []
        for other_id, (other_name, _) in held.items():
            if other_id != lock_id:
                new_edges.append((other_name, name))
        held[lock_id] = (name, 1)
        with self._mu:
            self._names[name] = self._names.get(name, 0) + 1
            fresh = [e for e in new_edges if e not in self._edges]
            for e in new_edges:
                rec = self._edges.get(e)
                if rec is None:
                    self._edges[e] = [1, ""]
                else:
                    rec[0] += 1
        if fresh:
            # one sample location per NEW edge (stack walk is pricey;
            # existing edges only bump a counter)
            where = _call_site()
            with self._mu:
                for e in fresh:
                    if self._edges[e][1] == "":
                        self._edges[e][1] = where

    def on_release(self, lock_id: int) -> None:
        held = self._held()
        rec = held.get(lock_id)
        if rec is None:                 # released by a non-tracked path
            return
        name, depth = rec
        if depth > 1:
            held[lock_id] = (name, depth - 1)
        else:
            del held[lock_id]

    # -- readout -------------------------------------------------------------

    def edges(self) -> Dict[Tuple[str, str], Tuple[int, str]]:
        with self._mu:
            return {e: (c, w) for e, (c, w) in self._edges.items()}

    def lock_names(self) -> List[str]:
        with self._mu:
            return sorted(self._names)

    def cycles(self) -> List[List[str]]:
        """Distinct elementary cycles in the name graph (DFS; each
        cycle reported once, rotated to its smallest node)."""
        adj: Dict[str, List[str]] = {}
        for (a, b) in self.edges():
            adj.setdefault(a, []).append(b)
        seen_cycles = set()
        out: List[List[str]] = []

        def dfs(node: str, path: List[str], on_path: set):
            for nxt in adj.get(node, ()):
                if nxt in on_path:
                    cyc = path[path.index(nxt):] + [nxt]
                    base = cyc[:-1]
                    rot = min(range(len(base)),
                              key=lambda i: base[i])
                    canon = tuple(base[rot:] + base[:rot])
                    if canon not in seen_cycles:
                        seen_cycles.add(canon)
                        out.append(list(canon) + [canon[0]])
                else:
                    path.append(nxt)
                    on_path.add(nxt)
                    dfs(nxt, path, on_path)
                    on_path.discard(nxt)
                    path.pop()

        for start in sorted(adj):
            dfs(start, [start], {start})
        return out

    def assert_acyclic(self) -> None:
        cycles = self.cycles()
        if cycles:
            edges = self.edges()
            lines = []
            for cyc in cycles:
                lines.append(" -> ".join(cyc))
                for a, b in zip(cyc, cyc[1:]):
                    c, w = edges.get((a, b), (0, "?"))
                    lines.append(f"    {a} -> {b}  (seen {c}x, "
                                 f"first at {w})")
            raise LockOrderError(
                "lock-acquisition cycle(s) detected — two threads "
                "taking these locks in opposite orders can deadlock:\n"
                + "\n".join(lines))

def _call_site() -> str:
    tname = threading.current_thread().name
    for frame in reversed(traceback.extract_stack(limit=12)[:-3]):
        if os.sep + "analysis" + os.sep not in frame.filename and \
                "threading" not in frame.filename:
            return (f"{os.path.basename(frame.filename)}:"
                    f"{frame.lineno} ({tname})")
    return f"? ({tname})"


class _TrackedLock:
    """Proxy delegating to a real Lock/RLock, reporting to the
    monitor. Wrapping an EXISTING lock object (the patch-table path)
    preserves mutual exclusion with any raw references — only the
    proxy's own acquisitions become visible."""

    __slots__ = ("_inner", "_name")

    def __init__(self, name: str, inner):
        self._name = name
        self._inner = inner

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            mon = _monitor
            if mon is not None:
                mon.on_acquired(id(self._inner), self._name)
        return got

    def release(self):
        mon = _monitor
        if mon is not None:
            mon.on_release(id(self._inner))
        self._inner.release()

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):                 # pragma: no cover - debug aid
        return f"<_TrackedLock {self._name} {self._inner!r}>"


_monitor: Optional[Monitor] = None
_env_armed = os.environ.get("LGBM_TPU_LOCK_ORDER", "") not in ("", "0")
_enabled = _env_armed
if _env_armed:                          # opt-in from the environment
    _monitor = Monitor()

    def _report_at_exit():              # pragma: no cover - env mode
        import atexit

        @atexit.register
        def _dump():
            cycles = _monitor.cycles()
            if cycles:
                import sys
                print("[lock-order] CYCLES detected:\n"
                      + "\n".join(" -> ".join(c) for c in cycles),
                      file=sys.stderr)

    _report_at_exit()


def named_lock(name: str):
    """A process lock belonging to the named lock CLASS. Plain
    ``threading.Lock`` unless detection is enabled — production pays
    nothing."""
    if not _enabled:
        return threading.Lock()
    if _env_armed:
        # env-armed mode has no detecting() entry point to apply the
        # patch table; piggyback on lock creation (rare — one per
        # booster/driver) to pick up module locks as they import.
        # Idempotent: already-wrapped and not-yet-imported are skipped
        _patch_globals()
    return _TrackedLock(name, threading.Lock())


def named_rlock(name: str):
    """Reentrant variant of ``named_lock`` (reentrant acquires are
    tracked once, not per depth)."""
    if not _enabled:
        return threading.RLock()
    if _env_armed:
        _patch_globals()
    return _TrackedLock(name, threading.RLock())


def _patch_globals() -> List[Tuple[object, str, object]]:
    """Swap the import-time module locks for tracked proxies (wrapping
    the ORIGINAL lock object). Returns restore records. Modules not
    yet imported are skipped — detection never forces an import."""
    import sys
    restore = []
    for mod_name, attr_path, lock_name in GLOBAL_LOCKS:
        holder = sys.modules.get(mod_name)
        if holder is None:
            continue
        *chain, attr = attr_path.split(".")
        for part in chain:
            holder = getattr(holder, part, None)
            if holder is None:
                break
        if holder is None:
            continue
        cur = getattr(holder, attr, None)
        if cur is None or isinstance(cur, _TrackedLock):
            continue
        setattr(holder, attr, _TrackedLock(lock_name, cur))
        restore.append((holder, attr, cur))
    return restore


@contextmanager
def detecting(patch_globals: bool = True):
    """Enable lock-order detection for a code block (the liveness-test
    seam). Locks created inside via the factories are tracked; known
    module-level locks are swapped for the window. Yields the
    ``Monitor``; the caller asserts ``monitor.assert_acyclic()`` (or
    inspects ``graph()``) after the block."""
    global _monitor, _enabled
    prev_mon, prev_en = _monitor, _enabled
    mon = Monitor()
    _monitor, _enabled = mon, True
    restore = _patch_globals() if patch_globals else []
    try:
        yield mon
    finally:
        for mod, attr, orig in restore:
            setattr(mod, attr, orig)
        _monitor, _enabled = prev_mon, prev_en
