"""Per-phase wall-clock accounting.

The JAX package's ``utils/timing.py`` (reference TIMETAG instrumentation,
src/treelearner/serial_tree_learner.cpp:14-41, and gbdt.cpp:253-256's
per-iteration elapsed time). Phase totals live in the metrics registry's
timer domain (obs/registry.py), which is thread-safe. CUDA launches are
asynchronous, so a phase's bucket holds the host time it spent issuing
work; a device phase ``.watch(out)``es its output, and the phase waits
for the card at exit so that the queued work lands in it. When the
span tracer is active (obs/trace.py), each phase is also a span on the
calling thread's row.

Left out until obs/profiler.py is ported (ROADMAP item 20): the profiler
annotations around each phase.
"""
from __future__ import annotations

import time
from contextlib import contextmanager

from ..obs import registry as _obs
from ..obs import trace as _trace
from . import log


class _PhaseHandle:
    """Yielded by ``phase``; a device phase registers the output whose
    completion the phase waits for at exit."""
    __slots__ = ("out",)

    def __init__(self):
        self.out = None

    def watch(self, out):
        """Register a tensor (or a list or tuple of them): the phase
        waits for the card at exit, so the queued device time is
        attributed here."""
        self.out = out
        return out


@contextmanager
def phase(name: str):
    """Accumulate the wall time spent inside the block under ``name``."""
    tracer = _trace.active()
    span_t0 = tracer.now_us() if tracer is not None else 0.0
    t0 = time.monotonic()
    h = _PhaseHandle()
    try:
        yield h
    finally:
        if h.out is not None:
            _sync(h.out)
        _obs.timer(name).add(time.monotonic() - t0)
        if tracer is not None:
            tracer.complete(name, "phase", span_t0)


def add(name: str, seconds: float) -> None:
    _obs.timer(name).add(seconds)


def reset() -> None:
    _obs.default_registry().reset_timers()


def seconds(prefix: str) -> float:
    """Total seconds of every phase whose name starts with ``prefix``."""
    return sum(total for name, total, _, _ in
               _obs.default_registry().timer_items()
               if name.startswith(prefix))


def _sync(out) -> None:
    """Wait for the card when ``out`` holds a CUDA tensor (the JAX
    package reads a scalar back; ``torch.cuda.synchronize`` drains the
    queue alike)."""
    import torch
    items = out if isinstance(out, (list, tuple)) else [out]
    for x in items:
        if torch.is_tensor(x) and x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
            _obs.counter("transfer/d2h_syncs").add(1)
            return


def measure(fn, *args, repeats: int = 5, warmup: int = 1) -> float:
    """Median of ``repeats`` wall seconds of ``fn(*args)``, with a wait
    for the card after each call; ``warmup`` untimed calls first."""
    for _ in range(max(warmup, 0)):
        _sync(fn(*args))
    times = []
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        _sync(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def report() -> str:
    """One line per phase, the largest total first: total, calls, mean,
    max."""
    items = sorted(_obs.default_registry().timer_items(),
                   key=lambda r: -r[1])
    lines = []
    for name, total, n, mx in items:
        n = max(n, 1)
        lines.append(f"  {name:<24s} {total:9.3f} s  ({n} calls, "
                     f"{1000.0 * total / n:.2f} ms avg, "
                     f"{1000.0 * mx:.2f} ms max)")
    return "\n".join(lines)


def log_report(header: str = "phase timings") -> None:
    """Log and reset: each report covers one run's deltas."""
    body = report()
    if body:
        log.info("%s:\n%s", header, body)
        reset()
