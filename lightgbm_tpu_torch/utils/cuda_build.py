"""Build the port's CUDA kernels and load them with ctypes.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for sm_90a into a
shared library with a plain C interface, under ``_build/`` (ignored by
git), keyed by a hash of the source and flags. ``build_all`` starts one
``nvcc`` per source at once and waits for all of them; ``library``
builds on first use, so a caller never needs a separate build step.
Nothing here runs when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, NamedTuple

from .log import LightGBMError

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD_DIR = os.path.join(PKG, "_build")
SOURCES = ("forest_predict", "hist_wave", "leaf_gather")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


class Built(NamedTuple):
    path: str        # the shared library
    seconds: float   # nvcc wall time (0.0 when it was already built)
    report: str      # nvcc's output (ptxas register and spill lines)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise LightGBMError("nvcc not found: the kernels are built from "
                            "lightgbm_tpu_torch/csrc on first use")
    return path


def _target(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as fh:
        digest = hashlib.sha1(fh.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}_{digest.hexdigest()[:16]}.so")


def build_all() -> Dict[str, Built]:
    """Compile every source not yet built, all nvcc processes at once.
    Raises with nvcc's errors if any source fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out: Dict[str, Built] = {}
    running = {}
    for name in SOURCES:
        path = _target(name)
        if os.path.exists(path):
            out[name] = Built(path, 0.0, "")
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp,
             os.path.join(CSRC, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, path, tmp, time.perf_counter())
    failed = []
    for name, (proc, path, tmp, t0) in running.items():
        report, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{name}.cu:\n{report}")
            continue
        os.replace(tmp, path)
        out[name] = Built(path, seconds, report)
    if failed:
        raise LightGBMError("\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _target(name)
            if not os.path.exists(path):
                path = build_all()[name].path
            lib = _libs[name] = ctypes.CDLL(path)
        return lib
