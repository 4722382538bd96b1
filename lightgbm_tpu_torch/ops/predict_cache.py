"""Serving-batch buckets and stack counters: the serving twin of the
JAX package's ``ops/predict_cache.py``.

Online micro-batches (1-4096 rows, the LRB loop's 64-row evaluation
calls) pad to power-of-two **serve buckets** (``serve_bucket_rows``;
floor 16, pow2/16 steps above 16k), as the JAX stacker pads them
(``StackedModel.predict``, ops/stacked_predict.py). Padding is bit-exact:
the forest kernel (K4) scores each row on its own and the pad rows are
sliced off before the scores leave the device wrapper. The chosen width
is noted on the calling thread's request context (obs/reqlog.py), so a
serving call's wide event records the bucket it rode.

Forest stacks are counted (``predict_cache/stacks`` full host builds,
``predict_cache/extends`` incremental appends, ``StackedModel.extend``,
``predict_cache/stacked_trees``), so "one stack per published model" and
"continued training extends instead of re-stacking" are assertable.

The registry (``get``): a bounded process-wide LRU of serving entries
keyed by the forest kernel's geometry and the serve bucket
(ops/stacked_predict.py ``_dispatch_key``). An entry is what does not
depend on one model's tables: the launch plan of that bucket and, on a
card, its staging (pinned host rows, the static device rows and scores,
a pinned result, an event, and a lock that serialises the threads that
share it), bounded by entries (``MAX_ENTRIES``) and by its staging's
bytes (``MAX_BYTES``). A model consults the registry once per geometry and keeps
the entry in its own memo, so ``hits`` count reuse across models (the
LRB loop's retrained window lands on its predecessor's entry), not
per-call traffic. Each model captures its own CUDA graph over an entry
(the copy in, K4 from rows, the copy out), because a graph holds the
addresses of the tables it was captured with; the graph lives in the
model's memo and is dropped with it. The JAX module's entries are
compiled programs; the port's are these buffers, and its graphs are
what replaces the compiled dispatch.

Knobs (config.py): ``tpu_predict_cache`` (-1 auto = on / 0 off: every
model builds its own entries, uncounted) and ``tpu_serve_bucket`` (-1
pow2 buckets / 0 exact shapes / N = round up to a multiple of N).
``stats()`` is snapshotted into run reports (``meta.predict_cache``).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Dict, Optional

from ..obs import registry as obs
from ..obs import reqlog
from ..obs import trace

# smallest serve bucket: a 1-row online request pads to 16 rows of
# kernel work; pow2 buckets above keep the widths logarithmic
SERVE_MIN_BUCKET = 16
# above this width, pow2/16 steps (8 buckets per octave) cap the pad
# at ~1/8
_POW2_CAP = 1 << 14

# bounded registry: one entry per distinct serving geometry; the LRU
# evict keeps a model-shape sweep from pinning every staging buffer
MAX_ENTRIES = 128
# and bounded by the bytes of its entries' staging (``nbytes``: pinned
# host and device, each up to ROW_CHUNK rows of the model's features)
MAX_BYTES = 1 << 30

_lock = threading.Lock()
_entries: "OrderedDict[tuple, object]" = OrderedDict()  # guarded-by: _lock
_bytes = 0          # their staging bytes  # guarded-by: _lock
_mode = -1          # config.tpu_predict_cache  (-1 auto / 0 off / 1 on)
_bucket = -1        # config.tpu_serve_bucket   (-1 pow2 / 0 exact / N)


def configure(predict_cache: int = -1, serve_bucket: int = -1) -> None:
    """Install the config knobs (called from GBDT.init)."""
    global _mode, _bucket
    _mode = int(predict_cache)
    _bucket = int(serve_bucket)


def enabled() -> bool:
    """Registry bookkeeping active? (-1 auto = on.)"""
    return _mode != 0


def serve_bucket_rows(n: int, policy: Optional[int] = None) -> int:
    """Padded request-batch width for ``n`` rows under the serving
    bucket policy (``tpu_serve_bucket``; ``policy`` is the calling
    booster's own knob so one booster's config cannot re-shape another
    live booster's serving path).

    -1 (auto): next power of two >= max(n, SERVE_MIN_BUCKET) up to
    16384; above that pow2/16 steps (pad capped at ~1/8).
    0: exact shapes.
    N > 0: round up to a multiple of N.

    The chosen width is noted on the calling thread's active request
    context (free no-op otherwise), so the wide event a serving entry
    writes carries the bucket its batch rode (obs/reqlog.py). Callers
    that clamp the answer (the stacker's row-chunk ceiling) re-note the
    clamped width: last note wins, and it is the truth."""
    b = _bucket_rows(int(n), policy)
    reqlog.note_bucket(b)
    return b


def _bucket_rows(n: int, policy: Optional[int]) -> int:
    p = (_bucket if policy is None else int(policy))
    if p == 0:
        return n
    if p > 0:
        return -(-n // p) * p
    b = max(n, SERVE_MIN_BUCKET)
    if b <= _POW2_CAP:
        return 1 << (b - 1).bit_length()
    return -(-b // (1 << ((b - 1).bit_length() - 4))) \
        * (1 << ((b - 1).bit_length() - 4))


def get(key: tuple, builder: Callable[[], object]) -> object:
    """Registry lookup: the process-wide serving entry for ``key``,
    built on first encounter. A hit means a later model of the same
    geometry reuses the entry's plan and staging."""
    if not enabled():
        return builder()
    with _lock:
        entry = _entries.get(key)
        if entry is not None:
            _entries.move_to_end(key)
            obs.counter("predict_cache/hits").add(1)
            trace.instant("predict_cache/hit", cat="cache")
            return entry
    obs.counter("predict_cache/misses").add(1)
    trace.instant("predict_cache/miss", cat="cache")
    entry = builder()
    size = int(getattr(entry, "nbytes", 0))
    global _bytes
    with _lock:
        have = _entries.get(key)
        if have is not None:
            # lost race: the same plan and buffers by key construction
            return have
        while _entries and (len(_entries) >= MAX_ENTRIES
                            or _bytes + size > MAX_BYTES):
            _, old = _entries.popitem(last=False)
            _bytes -= int(getattr(old, "nbytes", 0))
            obs.counter("predict_cache/evictions").add(1)
        _entries[key] = entry
        _bytes += size
    return entry


def held_bytes() -> int:
    """Staging bytes of the registry's entries (made or yet to be)."""
    with _lock:
        return _bytes


def count_stack(trees: int) -> None:
    """Record one FULL host-side forest stack (StackedModel._build)."""
    obs.counter("predict_cache/stacks").add(1)
    obs.counter("predict_cache/stacked_trees").add(int(trees))
    trace.instant("predict_cache/stack", cat="cache")


def count_extend(trees: int) -> None:
    """Record one INCREMENTAL stack: only ``trees`` appended trees were
    tabled (StackedModel.extend)."""
    obs.counter("predict_cache/extends").add(1)
    obs.counter("predict_cache/stacked_trees").add(int(trees))
    trace.instant("predict_cache/extend", cat="cache")


def stats() -> Dict:
    """Snapshot for run reports and the daemon (meta.predict_cache)."""
    with _lock:
        entries = len(_entries)
    return {
        "enabled": enabled(),
        "entries": entries,
        "hits": obs.counter("predict_cache/hits").value,
        "misses": obs.counter("predict_cache/misses").value,
        "evictions": obs.counter("predict_cache/evictions").value,
        "stacks": obs.counter("predict_cache/stacks").value,
        "extends": obs.counter("predict_cache/extends").value,
        "stacked_trees": obs.counter("predict_cache/stacked_trees").value,
    }


def clear() -> None:
    """Drop every entry (tests; models keep the entries in their memos)."""
    global _bytes
    with _lock:
        _entries.clear()
        _bytes = 0
