"""Atomic file replacement: the one copy of the tmp+rename pattern.

The JAX package's ``utils/fileio.py``: ``atomic_write``, and
``prune_numbered``, which keeps the newest CLI model snapshots. Every
artifact the port writes for readers that may look at it mid-run (the
span trace of obs/trace.py, the snapshots) follows the same discipline:
write to
``<path>.tmp.<pid>.<tid>``, ``os.replace`` into place, never leave a torn
file for a reader or a stale tmp on failure. Standard library only.
"""
from __future__ import annotations

import glob as _glob
import os
import re as _re
import threading
from contextlib import contextmanager
from typing import Callable, Optional


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


def prune_numbered(prefix: str, suffix_pattern: str, index_re: str,
                   keep: int,
                   companions: Optional[Callable] = None) -> None:
    """Best-effort keep-newest-K prune for numbered artifact families
    (model snapshots ``*.snapshot_iter_N``, checkpoint bundles
    ``ckpt_iter_N.json`` — utils/checkpoint.py): glob
    ``escape(prefix) + suffix_pattern`` (the prefix is caller data — a
    path with ``[``/``?`` in it must match literally, not as a glob
    class), rank by the ``index_re`` capture group (numeric, so
    r10 > r9), delete everything past the newest ``keep`` plus each
    victim's ``companions(path)`` sidecars. Deletion failures are
    ignored — pruning is hygiene, never a correctness step."""
    rx = _re.compile(index_re)
    found = []
    for p in _glob.glob(_glob.escape(prefix) + suffix_pattern):
        m = rx.search(p)
        if m:
            found.append((int(m.group(1)), p))
    for _, p in sorted(found, reverse=True)[max(int(keep), 1):]:
        extra = list(companions(p)) if companions is not None else []
        for victim in [p] + extra:
            try:
                os.unlink(victim)
            except OSError:
                pass
