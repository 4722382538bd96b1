"""Process-wide observability identity: (machine_rank, world, incarnation).

The JAX package's ``obs/identity.py``. Every telemetry surface of the
port (trace events, reqlog wide events) stamps the SAME identity record,
so artifacts from N ranks of one cluster correlate without filename
archaeology. The port has no cluster layer yet (ROADMAP item 19): until
one calls ``set_topology``, a process is rank 0 of a world of 1 at
incarnation 0, and every artifact path and record is the single-process
one.

Path policy: ``rank_suffixed(path)`` inserts ``.r<rank>`` before the
final extension when world > 1 (``trace.json`` -> ``trace.r1.json``) and
leaves single-process paths byte-identical.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, Optional

__all__ = ["identity", "rank", "incarnation", "is_multiprocess",
           "set_topology", "rank_suffixed"]

_lock = threading.Lock()
_state: Dict[str, int] = {      # guarded-by: _lock
    "machine_rank": 0,
    "world": 1,
    "incarnation": 0,
}


def identity() -> Dict[str, int]:
    """The current identity record, ready to embed in an artifact."""
    with _lock:
        return dict(_state)


def rank() -> int:
    return _state["machine_rank"]


def incarnation() -> int:
    return _state["incarnation"]


def is_multiprocess() -> bool:
    return _state["world"] > 1


def set_topology(machine_rank: int, world_n: int) -> None:
    """Record this process's place in the cluster (the writer a cluster
    layer calls at bootstrap). Idempotent for a repeated identical
    call."""
    with _lock:
        _state["machine_rank"] = int(machine_rank)
        _state["world"] = max(int(world_n), 1)


def rank_suffixed(path: str, rank_n: Optional[int] = None) -> str:
    """``path`` with ``.r<rank>`` inserted before the final extension
    when world > 1 (or when an explicit ``rank_n`` is given); returned
    unchanged single-process so single-rank artifact paths stay
    byte-identical."""
    if not path:
        return path
    r = rank_n if rank_n is not None else rank()
    if rank_n is None and not is_multiprocess():
        return path
    base, ext = os.path.splitext(path)
    return f"{base}.r{int(r)}{ext}" if ext else f"{path}.r{int(r)}"
