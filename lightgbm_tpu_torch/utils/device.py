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
