"""ctypes binding for the native C++ text parser.

The JAX package's ``io/native.py``, ``parse_file_native`` only, and
``parse_block_native`` for the two-round loader's blocks. The
parser's source is ``csrc/fast_parser.cpp`` (a copy of the JAX package's
``native/fast_parser.cpp``), built with g++ into ``_build/`` at first use
by ``utils/cuda_build.py``; a failed build raises, there is no quiet
fallback. The Python parser (io/parser.py) stays the semantic oracle
(tests/test_torch_cli.py holds the two bit for bit). The JAX module's
host binning (``bin_columns_native``) is not ported: the port bins on the
device (io/dataset.py ``bin_columns``).
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from ..utils import cuda_build

_lib = None
_lock = threading.Lock()


def _load() -> ctypes.CDLL:
    """The parser's library, built on first use, its types bound once."""
    global _lib
    with _lock:
        if _lib is None:
            lib = cuda_build.library("fast_parser")
            lib.lgbm_tpu_parse_count.argtypes = [
                ctypes.c_char_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32)]
            lib.lgbm_tpu_parse_count.restype = ctypes.c_int
            lib.lgbm_tpu_parse_fill.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int32,
                ctypes.c_int32, ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.c_int32]
            lib.lgbm_tpu_parse_fill.restype = ctypes.c_int
            lib.lgbm_tpu_parse_block.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_char,
                ctypes.c_int32, ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.c_int32]
            lib.lgbm_tpu_parse_block.restype = ctypes.c_int
            _lib = lib
        return _lib


def parse_file_native(filename: str, header: bool, label_idx: int
                      ) -> Optional[Tuple[np.ndarray,
                                          Optional[np.ndarray], int]]:
    """Parse with the native tokenizer.

    Returns (values [N, C] float64, labels [N] float32 or None, format:
    0 tsv, 1 csv, 2 libsvm), or None where the parser declines the file
    (it cannot be read, or its rows are ragged: the Python parser pads
    them and warns). ``C`` excludes the label column."""
    lib = _load()
    rows = ctypes.c_int64(0)
    cols = ctypes.c_int32(0)
    fmt = ctypes.c_int32(0)
    rc = lib.lgbm_tpu_parse_count(
        filename.encode(), 1 if header else 0,
        ctypes.byref(rows), ctypes.byref(cols), ctypes.byref(fmt))
    if rc != 0:
        return None
    n, c, f = rows.value, cols.value, fmt.value
    # delimited: a label column only exists when label_idx is in range
    # (the Python oracle's `width > label_idx` guard)
    has_label = label_idx >= 0 and (f == 2 or label_idx < c)
    feat_cols = max(c - (1 if (has_label and f != 2) else 0), 0)
    values = np.empty((n, feat_cols), np.float64)
    # zeros, not empty: libsvm rows without a label token keep 0.0, as
    # in the Python oracle
    labels = np.zeros(n, np.float32) if has_label else None
    rc = lib.lgbm_tpu_parse_fill(
        filename.encode(), 1 if header else 0,
        np.int32(label_idx if has_label else -1), np.int32(f),
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        (labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
         if labels is not None else None),
        np.int64(n), np.int32(feat_cols))
    if rc != 0:
        # rc 3: ragged rows
        return None
    return values, labels, f


def parse_block_native(lines, delim: str, label_idx: int, cols: int,
                       threads: int = 1
                       ) -> Optional[Tuple[np.ndarray, Optional[np.ndarray]]]:
    """Delimited data lines (bytes, without their line ends), each of
    ``cols`` feature columns beside the label column ``label_idx`` (< 0:
    none): (values [N, cols] float64, labels [N] float32 or None), or
    None for a ragged row (the Python parser pads it and warns). With
    ``threads`` > 1 the lines are cut into that many runs parsed at once
    (the library call releases the interpreter)."""
    lib = _load()
    n = len(lines)
    values = np.empty((n, cols), np.float64)
    labels = np.zeros(n, np.float32) if label_idx >= 0 else None

    def run(a: int, b: int) -> int:
        buf = b"\n".join(lines[a:b])
        return lib.lgbm_tpu_parse_block(
            buf, len(buf), delim.encode(), np.int32(label_idx),
            values[a:b].ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            (labels[a:b].ctypes.data_as(ctypes.POINTER(ctypes.c_float))
             if labels is not None else None),
            np.int64(b - a), np.int32(cols))

    cuts = np.linspace(0, n, max(min(int(threads), n), 1) + 1).astype(int)
    if len(cuts) > 2:
        import concurrent.futures
        with concurrent.futures.ThreadPoolExecutor(len(cuts) - 1) as ex:
            rcs = list(ex.map(run, cuts[:-1], cuts[1:]))
    else:
        rcs = [run(0, n)]
    if any(rcs):
        return None
    return values, labels
