"""Atomic file replacement: the one copy of the tmp+rename pattern.

The JAX package's ``utils/fileio.py`` ``atomic_write``. Every artifact
the port writes for readers that may look at it mid-run (the span trace
of obs/trace.py) follows the same discipline: write to
``<path>.tmp.<pid>.<tid>``, ``os.replace`` into place, never leave a torn
file for a reader or a stale tmp on failure. Standard library only.
"""
from __future__ import annotations

import os
import threading
from contextlib import contextmanager


@contextmanager
def atomic_write(path: str, mode: str = "w"):
    """Yield a file handle whose contents replace ``path`` atomically
    on clean exit; on ANY failure the temp file is removed and ``path``
    is untouched. Parent directories are created. The temp name is
    pid+tid-unique: two threads writing the same path (the LRB loop's
    per-window trace flush vs a re-targeting configure) each publish a
    complete document instead of interleaving one shared tmp file."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, mode) as fh:
            yield fh
        os.replace(tmp, path)
    finally:
        try:                    # failed write: no stale tmp left behind
            os.unlink(tmp)      # (already renamed away on success)
        except OSError:
            pass
