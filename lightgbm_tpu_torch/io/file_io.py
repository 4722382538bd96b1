"""Virtual file abstraction: scheme-dispatched readers/writers.

The JAX package's ``io/file_io.py``, copied: the reference's
VirtualFileReader/Writer + optional HDFS backend
(include/LightGBM/utils/file_io.h:1-74,
src/io/file_io.cpp:54-120 — a vtable over local stdio and libhdfs).
Here the same seam is a scheme registry over Python file objects:
local paths open directly; ``hdfs://`` routes through pyarrow's
HadoopFileSystem when that optional dependency exists (this image ships
without it, so the backend is gated with an actionable error, matching
the reference's USE_HDFS build flag being off by default).

Register new schemes with ``register_scheme("s3", opener)`` where
``opener(path, mode)`` returns a file object.
"""
from __future__ import annotations

from typing import Callable, Dict

from ..utils import log

_SCHEMES: Dict[str, Callable] = {}


def register_scheme(scheme: str, opener: Callable) -> None:
    """opener(path: str, mode: str) -> file object."""
    _SCHEMES[scheme] = opener


def _split_scheme(path: str) -> str:
    i = path.find("://")
    if i <= 0:
        return ""
    head = path[:i]
    # windows drive letters are not schemes
    return head if len(head) > 1 else ""


def _hdfs_open(path: str, mode: str):
    try:
        from pyarrow import fs as pafs
    except ImportError:
        log.fatal(
            "hdfs:// paths need the optional pyarrow dependency "
            "(the reference gates its HDFS backend behind USE_HDFS "
            "the same way, file_io.cpp:54)")
    hdfs = pafs.HadoopFileSystem.from_uri(path)
    inner = path.split("://", 1)[1]
    inner = "/" + inner.split("/", 1)[1] if "/" in inner else "/"
    if "r" in mode:
        f = hdfs.open_input_stream(inner)
    else:
        f = hdfs.open_output_stream(inner)
    if "b" not in mode:
        import io
        return io.TextIOWrapper(f)
    return f


register_scheme("hdfs", _hdfs_open)


def open_file(path: str, mode: str = "r"):
    """Open ``path`` through the scheme registry (local files by
    default) — the VirtualFileReader/Writer::Make dispatch."""
    scheme = _split_scheme(path)
    if scheme in _SCHEMES:
        return _SCHEMES[scheme](path, mode)
    if scheme and scheme not in ("file",):
        log.fatal(f"Unknown file scheme {scheme!r} for {path}; "
                  "register one with lightgbm_tpu_torch.io.file_io."
                  "register_scheme")
    if scheme == "file":
        path = path.split("://", 1)[1]
    return open(path, mode)


def exists(path: str) -> bool:
    """VirtualFileWriter::Exists."""
    scheme = _split_scheme(path)
    if not scheme or scheme == "file":
        import os
        return os.path.exists(path.split("://", 1)[-1])
    try:
        with open_file(path, "rb"):
            return True
    except Exception:
        return False
