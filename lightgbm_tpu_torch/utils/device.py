"""Device resolution and the thread-safe counters the kernel routes keep.

The port's entry points run on the card. ``resolve_device(None)`` is
``cuda:0`` and raises when CUDA is absent; the CPU is used only when a
caller names it (``device="cpu"``), as the tests do. Nothing falls back
to the CPU quietly.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Union

import torch

from .log import LightGBMError


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """None -> cuda:0 (raises without CUDA); "cpu" only when asked."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise LightGBMError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise LightGBMError(f"unsupported device {device!r}")
    return dev


def on_device(dev: torch.device):
    """A context that makes ``dev`` the current CUDA device for a kernel
    launch: nothing when it already is (the usual case, and the cheap
    one), else ``torch.cuda.device(dev)``."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


_sms = {}
_plans = {}


def card_plan(plan, items: int, dev: torch.device, smem_query: tuple,
              resident_query: tuple) -> dict:
    """``plan`` (a NamedTuple with ``smem``) on ``dev`` as a dict, with
    ``blocks_per_sm``, the blocks of its kernel the card holds resident on
    an SM (its own occupancy count: ``resident_query``, a library
    function and its arguments), and ``grid``, one wave of those blocks
    and at most one per work item (``items``). The library's byte count
    (``smem_query``) must agree with the plan's shared memory, and a
    block must fit an SM."""
    key = (dev.index, plan, resident_query[0].__name__, resident_query[1:])
    got = _plans.get(key)
    if got is not None:
        return got
    with on_device(dev):
        lib_smem = smem_query[0](*smem_query[1:])
        resident = resident_query[0](*resident_query[1:])
    if lib_smem != plan.smem:
        raise LightGBMError(f"{plan}: {plan.smem} bytes of shared memory, "
                            f"the kernel's {lib_smem}")
    if resident < 1:
        raise LightGBMError(f"{plan} fits no SM ({resident})")
    sms = _sms.get(dev.index)
    if sms is None:
        sms = _sms[dev.index] = \
            torch.cuda.get_device_properties(dev).multi_processor_count
    got = _plans[key] = dict(plan._asdict(), blocks_per_sm=resident,
                             grid=min(items, resident * sms))
    return got


# the calling thread's capture (capture_graph): while it records, the
# launch counters' adds go to its tally, and each replay adds them
_capturing = threading.local()


class Captured:
    """A CUDA graph and the counter adds its capture recorded: the
    kernels it holds count at every replay, where they launch."""

    def __init__(self, graph, tally: list):
        self.graph = graph
        self.tally = tally

    def replay(self) -> None:
        self.graph.replay()
        for counter, k in self.tally:
            counter.add(k)


def capture_graph(fn, dev: torch.device, pool=None) -> Captured:
    """``fn``'s work on ``dev`` recorded into a CUDA graph, returned and
    not run. ``fn`` has run once already, uncaptured, so that the lazy
    set-up it does (a library's first load, its launch plans, cub's and
    the allocator's first blocks) is behind it. The capture runs on a
    side stream ordered after the current one (the calling thread's own,
    ``_capture_stream``), in thread-local mode, so
    other threads' CUDA calls (the LRB loop's trainer beside its
    server) are not refused while it records; ``pool`` is a memory pool
    to share with other graphs that never run at once. Counter adds made
    while it records (``Counter.add``) go to the graph's tally. A
    failure raises."""
    graph = torch.cuda.CUDAGraph()
    current = torch.cuda.current_stream(dev)
    side = _capture_stream(dev)
    side.wait_stream(current)
    tally: list = []
    with torch.cuda.stream(side):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        _capturing.tally = tally
        try:
            fn()
        except BaseException:
            _capturing.tally = None
            # the capture is void; fn's error says why
            with contextlib.suppress(Exception):
                graph.capture_end()
            raise
        _capturing.tally = None
        graph.capture_end()
    current.wait_stream(side)
    return Captured(graph, tally)


def _capture_stream(dev: torch.device):
    """The calling thread's capture stream on ``dev``, made once. The
    allocator reuses a freed block only for the stream it was allocated
    on, so graphs that share a memory pool reuse each other's freed
    memory only when they are captured on one stream (torch.cuda.graph
    keeps one default capture stream for the same reason)."""
    streams = getattr(_capturing, "streams", None)
    if streams is None:
        streams = _capturing.streams = {}
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    side = streams.get(key)
    if side is None:
        side = streams[key] = torch.cuda.Stream(dev)
    return side


class Counter:
    """An integer that several threads may add to (launch and fallback
    counts a run reads to show which route it took)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._n = 0

    def add(self, k: int = 1) -> None:
        tally = getattr(_capturing, "tally", None)
        if tally is not None:       # recorded, not launched: replays count
            tally.append((self, k))
            return
        with self._lock:
            self._n += k

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        with self._lock:
            return self._n
