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


class Counter:
    """An integer that several threads may add to (launch and fallback
    counts a run reads to show which route it took)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._n = 0

    def add(self, k: int = 1) -> None:
        with self._lock:
            self._n += k

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        with self._lock:
            return self._n
