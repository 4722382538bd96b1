"""Process-wide training-step registry: the JAX package's
``ops/step_cache.py`` on the card, with CUDA graphs where the JAX
package caches compiled programs.

The LRB loop (lrb.py) trains a fresh booster every window. The JAX
package makes its fused iteration a pure function of a hashable geometry
key and keeps the compiled program process-wide, so a later booster of
the same geometry skips the compile. The port compiles nothing per
shape; what it pays is the host's dispatch of a wave's many small
launches (about 2,600 an LRB iteration). So an entry here is a wave
grower's static state: its padded inputs, its per-tree tables and one
CUDA graph per wave width, captured at a width's first wave and replayed
from then on (ops/wave_grower.py ``WaveState``). A later booster of the
same geometry leases the entry, copies its bins and feature metadata
into the static buffers, and replays the graphs captured for an earlier
one: a hit (``step_cache/hits``), as the JAX package counts the next
LRB window.

The geometry (models/gbdt.py ``_step_pool``) is what a capture bakes
in: the padded rows, the f32 passes' row ranges at each wave width
(planned from the counted rows), the bin matrix's rows and dtype, F, the
histogram tier and every field of ``WaveGrowerConfig`` (B, the leaf
budget, W, the split hyperparameters). F pads to ``bucket_features``
(a multiple of 8) with trivial features, as the JAX package's does
(num_bin 1: no split candidate; feature mask False), so windows that
drop a different count of trivial columns share graphs; the f32 passes
plan their row ranges from F's bucket on every route
(``hist_wave.hist_plan``), so the pad leaves the order of addition as it
is uncached. The rows pad to ``bucket_rows`` and ride as uncounted columns, the
way valid passengers do, so the trees' bits do not depend on the pad; B
pads to ``bucket_bins``.

The registry is bounded by entries (``MAX_ENTRIES``) and by the device
bytes its states hold (``MAX_BYTES``): each holds a padded copy of its
owner's bins, so that a later booster's bins can be copied into the
addresses its graphs read, besides the booster's own; the bound caps
what the registry keeps for boosters already gone.

An entry serves one booster at a time: ``StepPool.lease`` hands a
booster the entry it used last, else a free one (whose buffers it then
reloads), else a new one, for one iteration. Two boosters training at
once (cv's folds, the pipelined loop) never hold the same entry.

Knobs (config.py): ``tpu_step_cache`` (-1 auto = on / 0 off: every tree
runs its waves eagerly on the booster's own tensors) and
``tpu_row_bucket`` (-1 pow2 buckets / 0 exact shapes / N = round up to a
multiple of N). ``stats()`` (``hits``, ``misses``, ``evictions``, the
capture seconds as ``compile_s``) is snapshotted into run reports
(``meta.step_cache``) and the LRB record (``step_cache_hits``).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Dict, Optional

from ..obs import registry as obs
from ..obs import trace

# bounded registry: one pool per distinct training geometry; the LRU
# evict keeps a sweep (a num_leaves grid search) from pinning every
# pool's buffers and graphs
MAX_ENTRIES = 64
# and bounded by the device bytes its pools hold (``StepPool.nbytes``):
# a HIGGS-scale state (11M rows x 28 features) holds about 0.5 GB, its
# padded copy of the bins 0.32 GB of it
MAX_BYTES = 4 << 30

# smallest pow2 bucket the auto policy pads to
MIN_BUCKET = 256
# a cached geometry's features pad to a multiple of this
FEATURE_PAD = 8

_lock = threading.Lock()
_steps: "OrderedDict[tuple, StepPool]" = OrderedDict()  # guarded-by: _lock
_mode = -1          # config.tpu_step_cache   (-1 auto / 0 off / 1 on)
_bucket = -1        # config.tpu_row_bucket   (-1 pow2 / 0 exact / N)


def configure(step_cache: int = -1, row_bucket: int = -1) -> None:
    """Install the config knobs (called from GBDT.init)."""
    global _mode, _bucket
    _mode = int(step_cache)
    _bucket = int(row_bucket)


def enabled() -> bool:
    """Cross-booster step reuse active? (-1 auto = on.)"""
    return _mode != 0


def bucket_rows(n: int, align: int = 1, policy: Optional[int] = None) -> int:
    """Padded row-block width for ``n`` data rows under the bucketing
    policy, always a multiple of ``align``. ``policy`` is the calling
    booster's own ``tpu_row_bucket``.

    -1 (auto): next power of two >= max(n, MIN_BUCKET) up to 16384;
    above that, pow2/16 steps (the pad capped at ~1/8).
    0: exact shapes (only the alignment pad).
    N > 0: round up to a multiple of N."""
    align = max(int(align), 1)
    p = (_bucket if policy is None else int(policy))
    if p == 0:
        return _round_up(n, align)
    if p > 0:
        return _round_up(_round_up(n, p), align)
    return _round_up(pow2_bucket(n, MIN_BUCKET), align)


def shard_align_unit(n: int, D: int, kchunk: int) -> int:
    """Row-alignment unit of a D-device row-sharding learner: shards
    chunk-align only when the data is large enough that the pad stays
    small (n >= 4*D*kchunk), else they align to the device count alone.
    The port trains on one card (D = 1); kept for the bucketed widths
    the JAX package's learners compute."""
    return D * kchunk if n >= 4 * D * kchunk else D


def pow2_bucket(x: int, floor: int) -> int:
    """The shared shape taper: next power of two >= max(x, floor) up to
    16384; above that, pow2/16 steps (8 buckets per octave)."""
    b = max(int(x), int(floor))
    if b <= (1 << 14):
        return 1 << (b - 1).bit_length()
    return _round_up(b, 1 << ((b - 1).bit_length() - 4))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def bucket_features(f: int) -> int:
    """Padded feature-axis width for ``f`` features: the next multiple
    of FEATURE_PAD (the JAX package's gbdt.py:523-529, under every row
    policy). The pad features are trivial: num_bin 1, no split
    candidate, feature mask False."""
    f = max(int(f), 1)
    return f + (-f) % FEATURE_PAD


def bucket_bins(b: int, policy: Optional[int] = None) -> int:
    """Padded histogram bin-axis width for ``b`` actual global bins: the
    next power of two, floor 16 (the packed tier's B <= 16 bound is
    never crossed by padding alone); exact under ``tpu_row_bucket=0``.
    Sound because the split search masks each feature by its own
    ``num_bin``."""
    p = (_bucket if policy is None else int(policy))
    if p == 0:
        return b
    return 1 << (max(b, 16) - 1).bit_length()


def bucket_entries(e: int, policy: Optional[int] = None) -> int:
    """Padded sparse-coordinate length for ``e`` explicit entries: -1
    (auto) next power of two (floor 1024) with pow2/16 steps above 16k;
    0 exact; N > 0 multiples of N."""
    p = (_bucket if policy is None else int(policy))
    if p == 0:
        return max(int(e), 1)
    if p > 0:
        return _round_up(max(int(e), 1), p)
    return pow2_bucket(e, 1024)


def aux_signature(aux) -> tuple:
    """Hashable structure + shape + dtype fingerprint of an aux tree
    (nested dicts of arrays or tensors, or None)."""
    if aux is None:
        return ("none",)
    if isinstance(aux, dict):
        return tuple((k, aux_signature(aux[k])) for k in sorted(aux))
    return (tuple(getattr(aux, "shape", ())),
            str(getattr(aux, "dtype", type(aux).__name__)))


class StepPool:
    """The registry's value for one geometry: its entries (wave grower
    states, ops/wave_grower.py ``WaveState``), each leased to one
    booster at a time."""

    def __init__(self, key: tuple, build: Callable[[], object]):
        self.key = key
        self._build = build
        self._lock = threading.Lock()
        self._free: list = []         # guarded-by: _lock
        self._all: list = []          # guarded-by: _lock

    def lease(self, owner) -> object:
        """An entry for ``owner`` (a booster's bin token) until
        ``release``: the one it held last if free, else any free one,
        else a new one."""
        with self._lock:
            for i, e in enumerate(self._free):
                if e.owner is owner:
                    return self._free.pop(i)
            if self._free:
                return self._free.pop()
        entry = self._build()
        with self._lock:
            self._all.append(entry)
        return entry

    def release(self, entry) -> None:
        """``entry`` free again; the registry then trims to its bytes
        (a state's buffers and graphs grow while it is leased)."""
        with self._lock:
            self._free.append(entry)
        _trim(self)

    def nbytes(self) -> int:
        """Device bytes its entries hold (``WaveState.nbytes``)."""
        with self._lock:
            return sum(e.nbytes() for e in self._all)


def get_step(key: tuple, builder: Callable[[], object]) -> StepPool:
    """Registry lookup: the process-wide pool for ``key``, built on first
    encounter (``builder`` makes one entry). A booster looks up once, so
    a hit is a later booster landing on an earlier one's captures."""
    with _lock:
        pool = _steps.get(key)
        if pool is not None:
            _steps.move_to_end(key)
            obs.counter("step_cache/hits").add(1)
            trace.instant("step_cache/hit", cat="cache")
            return pool
    obs.counter("step_cache/misses").add(1)
    trace.instant("step_cache/miss", cat="cache")
    pool = StepPool(key, builder)
    with _lock:
        have = _steps.get(key)
        if have is not None:
            return have
        while len(_steps) >= MAX_ENTRIES:
            _steps.popitem(last=False)
            obs.counter("step_cache/evictions").add(1)
        _steps[key] = pool
    return pool


def _trim(used: StepPool) -> None:
    """Evict the pools used least recently, ``used`` (the pool a booster
    just released, now the most recent) aside, until the registry holds
    at most ``MAX_BYTES``. A booster that holds an evicted pool keeps
    using it; its memory goes with the last such booster."""
    with _lock:
        if _steps.get(used.key) is used:
            _steps.move_to_end(used.key)
        pools = list(_steps.values())
    sizes = {id(p): p.nbytes() for p in pools}
    total = sum(sizes.values())
    for p in pools:
        if total <= MAX_BYTES:
            break
        if p is used:
            continue
        with _lock:
            if _steps.get(p.key) is not p:
                continue
            del _steps[p.key]
        total -= sizes[id(p)]
        obs.counter("step_cache/evictions").add(1)


def held_bytes() -> int:
    """Device bytes the registry's pools hold (phase 28 reads it)."""
    with _lock:
        pools = list(_steps.values())
    return sum(p.nbytes() for p in pools)


def record_capture(seconds: float) -> None:
    """One wave graph captured (its warm-up wave and the recording):
    the ``step_cache/compile`` timer, read as capture seconds."""
    obs.timer("step_cache/compile").add(seconds)


def stats() -> Dict:
    """Snapshot for run reports and the LRB record (meta.step_cache)."""
    t = obs.timer("step_cache/compile")
    with _lock:
        entries = len(_steps)
    return {
        "enabled": enabled(),
        "entries": entries,
        "hits": obs.counter("step_cache/hits").value,
        "misses": obs.counter("step_cache/misses").value,
        "evictions": obs.counter("step_cache/evictions").value,
        "compile_s": round(t.total, 3),
        "compiles": t.count,
    }


def clear() -> None:
    """Drop every pool (tests; frees the buffers and graphs once their
    boosters let go)."""
    with _lock:
        _steps.clear()
