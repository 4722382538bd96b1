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

Forest stacks are counted (``predict_cache/stacks`` host builds,
``predict_cache/stacked_trees``), so "one stack per published model" is
assertable.

Left out, and why: the JAX module's registry of compiled dispatch
wrappers keyed by geometry, with its hit/miss/eviction counters. It
exists there because every new row shape or table geometry compiles a
new XLA program. K4 is one hand-built kernel that takes any row count
and any model geometry at launch, so the registry would hold nothing and
its counters could only read 0. Also left out: the incremental stack
(``StackedModel.extend``, ``count_extend``); the port rebuilds a
model's stack when its trees change, so an extend count would only read
0 as well.

Knob (config.py): ``tpu_serve_bucket`` (-1 pow2 buckets / 0 exact
shapes / N = round up to a multiple of N). ``tpu_predict_cache`` turns
the JAX module's registry off and so has nothing to govern here.
"""
from __future__ import annotations

from typing import Dict, Optional

from ..obs import registry as obs
from ..obs import reqlog
from ..obs import trace

# smallest serve bucket: a 1-row online request pads to 16 rows of
# kernel work; pow2 buckets above keep the widths logarithmic
SERVE_MIN_BUCKET = 16
# above this width, pow2/16 steps (8 buckets per octave) cap the pad
# at ~1/8
_POW2_CAP = 1 << 14

_bucket = -1        # config.tpu_serve_bucket   (-1 pow2 / 0 exact / N)


def configure(serve_bucket: int = -1) -> None:
    """Install the process default of ``tpu_serve_bucket`` (called from
    GBDT.init)."""
    global _bucket
    _bucket = int(serve_bucket)


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


def count_stack(trees: int) -> None:
    """Record one host-side forest stack (StackedModel._build)."""
    obs.counter("predict_cache/stacks").add(1)
    obs.counter("predict_cache/stacked_trees").add(int(trees))
    trace.instant("predict_cache/stack", cat="cache")


def stats() -> Dict:
    """Snapshot of the serve-bucket default and the stack counters."""
    return {
        "serve_bucket": _bucket,
        "stacks": obs.counter("predict_cache/stacks").value,
        "stacked_trees": obs.counter("predict_cache/stacked_trees").value,
    }
