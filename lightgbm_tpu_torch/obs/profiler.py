"""The profiler window: ``torch.profiler`` over a bracket of iterations.

The JAX package's ``obs/profiler.py`` (there on ``jax.profiler``).
Brackets training iterations with a ``torch.profiler.profile`` (config
``tpu_profile_dir``): ``tpu_profile_iters = 0`` traces the whole
boosting loop; ``N > 0`` traces exactly N iterations starting at
iteration 2, skipping the first iteration (the kernels' build and the
first allocations) so the capture shows steady-state work. While a
window is open, utils/timing.py wraps every phase in a
``torch.profiler.record_function("lgbm/<name>")`` range
(``set_trace_annotations``), so the engine's phase names appear as
ranges beside the CUDA kernels. The window writes one Chrome trace,
``<tpu_profile_dir>/trace_<pid>.json`` (``trace_path``), loadable in
Perfetto or chrome://tracing.

The activities are the CPU's and, when the booster trains on a card,
CUDA's (kernel launches and their device time). A profiler that fails
to start logs a warning and training goes on untraced: the window is an
observability aid, not a failure mode.
"""
from __future__ import annotations

import os

from ..utils import log, timing


class ProfileWindow:
    """A ``torch.profiler`` bracket over a configurable iteration window.

    Drivers call ``iter_begin(it)`` / ``iter_end(it)`` with 1-based
    iteration numbers and ``close()`` after the loop (idempotent; also
    the safety net for early stops while the trace is open). ``device``:
    the booster's device; CUDA activity is recorded on a card.
    """

    def __init__(self, trace_dir: str = "", iters: int = 0, device=None):
        self.trace_dir = trace_dir or ""
        self.iters = max(int(iters or 0), 0)
        self.device = device
        self.trace_path = ""
        self._prof = None
        self._done = False
        self._annotations_installed = False

    @property
    def enabled(self) -> bool:
        return bool(self.trace_dir)

    def _start_at(self) -> int:
        # whole-run trace starts at iteration 1; a bounded window skips
        # the first iteration
        return 1 if self.iters == 0 else 2

    def _activities(self) -> list:
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device is not None and \
                torch.device(self.device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def iter_begin(self, it: int) -> None:
        if (not self.enabled or self._prof is not None or self._done
                or it < self._start_at()):
            return
        import torch
        try:
            os.makedirs(self.trace_dir, exist_ok=True)
            prof = torch.profiler.profile(activities=self._activities())
            prof.__enter__()
        except Exception as e:          # noqa: BLE001 — tracing is an
            # observability aid; a failing profiler must not stop training
            log.warning("torch.profiler failed to start (%s): %s",
                        self.trace_dir, e)
            self.trace_dir = ""
            return
        self._prof = prof
        timing.set_trace_annotations(True)
        self._annotations_installed = True
        log.info("profiler trace started (dir=%s, window=%s)",
                 self.trace_dir,
                 "whole run" if self.iters == 0
                 else f"{self.iters} iterations from iteration "
                      f"{self._start_at()}")

    def iter_end(self, it: int) -> None:
        if (self._prof is None or self.iters == 0
                or it < self._start_at() + self.iters - 1):
            return
        self._stop()

    def close(self) -> None:
        if self._prof is not None:
            self._stop()
        if self._annotations_installed:
            timing.set_trace_annotations(False)
            self._annotations_installed = False

    def _stop(self) -> None:
        prof, self._prof = self._prof, None
        self._done = True
        timing.set_trace_annotations(False)
        self._annotations_installed = False
        try:
            if self.device is not None:
                import torch
                if torch.device(self.device).type == "cuda":
                    torch.cuda.synchronize(self.device)
            prof.__exit__(None, None, None)
            path = os.path.join(self.trace_dir,
                                f"trace_{os.getpid()}.json")
            prof.export_chrome_trace(path)
            self.trace_path = path
            log.info("profiler trace written to %s", path)
        except Exception as e:          # noqa: BLE001
            log.warning("torch.profiler trace failed: %s", e)
