"""Build the port's CUDA kernels, its native parser and its linkable C
ABI; load the first two with ctypes.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for sm_90a, and the
text parser ``csrc/fast_parser.cpp`` by ``g++`` for the host, into a
shared library with a plain C interface, under ``_build/`` (ignored by
git), keyed by a hash of the source and flags. ``capi_library`` builds
``csrc/c_api_embed.cpp`` by ``g++`` against the running Python into
``_build/capi_<hash>/liblightgbm_tpu_torch.so``, for C and C++ programs
to link (the fork's ``src/test.cpp`` drivers). ``build_all`` starts one
compiler per source at once and waits for all of them, under a file lock
that keeps two processes from building into ``_build/`` at once; ``library``
builds on first use (every kernel source together, the parser alone),
so a caller never needs a separate build step, and a failed build
raises.
``compile_seconds`` is the compiler wall time this process has paid so far
(the LRB loop's per-window ``compile_s``). Nothing here runs when a
module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
import threading
import time
from typing import Dict, NamedTuple

from .log import LightGBMError

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD_DIR = os.path.join(PKG, "_build")
SOURCES = ("forest_predict", "hist_wave", "leaf_gather", "categorical")
HOST_SOURCES = ("fast_parser",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")
CAPI_SOURCE = "c_api_embed"
CAPI_NAME = "lightgbm_tpu_torch"     # liblightgbm_tpu_torch.so
CAPI_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++14")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_paid_lock = threading.Lock()
_paid_s = 0.0       # guarded-by: _paid_lock


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


def _gxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise LightGBMError("g++ not found: the native text parser is "
                            "built from lightgbm_tpu_torch/csrc on first "
                            "use")
    return path


def _source(name: str) -> str:
    ext = "cpp" if name in HOST_SOURCES else "cu"
    return os.path.join(CSRC, f"{name}.{ext}")


def _target(name: str) -> str:
    flags = GXX_FLAGS if name in HOST_SOURCES else NVCC_FLAGS
    with open(_source(name), "rb") as fh:
        digest = hashlib.sha1(fh.read() + " ".join(flags).encode())
    return os.path.join(BUILD_DIR, f"{name}_{digest.hexdigest()[:16]}.so")


def build_all(names=SOURCES + HOST_SOURCES) -> Dict[str, Built]:
    """Compile every source of ``names`` not yet built, all compilers at
    once. Raises with the compiler's errors if any source fails. Holds
    ``_build/.lock`` (an exclusive ``flock``) meanwhile, so that processes
    that start together (the ranks of a distributed run) never build into
    the directory at once: the later ones find the libraries built."""
    import fcntl
    os.makedirs(BUILD_DIR, exist_ok=True)
    # atomic-ok: an empty lock file, never read
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            return _build_all(names)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _build_all(names) -> Dict[str, Built]:
    global _paid_s
    out: Dict[str, Built] = {}
    running = {}
    for name in names:
        path = _target(name)
        if os.path.exists(path):
            out[name] = Built(path, 0.0, "")
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = ([_gxx(), *GXX_FLAGS] if name in HOST_SOURCES
               else [_nvcc(), *NVCC_FLAGS])
        proc = subprocess.Popen(
            [*cmd, "-o", tmp, _source(name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, path, tmp, time.perf_counter())
    failed = []
    for name, (proc, path, tmp, t0) in running.items():
        report, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(_source(name))} failed to "
                          f"build:\n{report}")
            continue
        os.replace(tmp, path)
        out[name] = Built(path, seconds, report)
    if running:
        wall = time.perf_counter() - min(t0 for *_, t0 in running.values())
        with _paid_lock:
            _paid_s += wall
    if failed:
        raise LightGBMError("\n".join(failed))
    return out


def compile_seconds() -> float:
    """Compiler wall seconds paid by this process's builds so far."""
    with _paid_lock:
        return _paid_s


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (or ``.cpp``), built on
    first use: a kernel source with every other kernel source, the
    parser alone."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _target(name)
            if not os.path.exists(path):
                group = SOURCES if name in SOURCES else (name,)
                path = build_all(group)[name].path
            lib = _libs[name] = ctypes.CDLL(path)
        return lib


def python_link_flags() -> list:
    """g++ flags that embed the running Python: its include directory,
    its shared library's directory and name, from ``sysconfig`` (not the
    ``python3-config`` script, which an installation may lack). Raises
    with the path looked for when ``Python.h`` or the library is
    missing."""
    inc = sysconfig.get_paths()["include"]
    if not os.path.exists(os.path.join(inc, "Python.h")):
        raise LightGBMError(f"Python.h not found in {inc}: the C ABI "
                            "embeds Python and needs its headers")
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ldlib = sysconfig.get_config_var("LDLIBRARY") or ""
    if not os.path.exists(os.path.join(libdir, ldlib)):
        raise LightGBMError(
            f"{os.path.join(libdir, ldlib)} not found: the C ABI embeds "
            "Python and links its shared library")
    ver = f"python{sys.version_info.major}.{sys.version_info.minor}"
    return [f"-I{inc}", f"-L{libdir}", f"-l{ver}", "-ldl", "-lm",
            f"-Wl,-rpath,{libdir}"]


def capi_library() -> str:
    """The path of ``liblightgbm_tpu_torch.so``, the linkable C ABI,
    built from ``csrc/c_api_embed.cpp`` on first use (a directory of its
    own under ``_build/``, keyed by the source, the flags and the
    Python it embeds). A failed build raises with g++'s errors."""
    global _paid_s
    flags = [*CAPI_FLAGS, *python_link_flags()]
    src = os.path.join(CSRC, f"{CAPI_SOURCE}.cpp")
    with open(src, "rb") as fh:
        digest = hashlib.sha1(fh.read() + " ".join(flags).encode())
    out_dir = os.path.join(BUILD_DIR, f"capi_{digest.hexdigest()[:16]}")
    path = os.path.join(out_dir, f"lib{CAPI_NAME}.so")
    with _lock:
        if os.path.exists(path):
            return path
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([_gxx(), src, "-o", tmp, *flags],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        with _paid_lock:
            _paid_s += time.perf_counter() - t0
        if proc.returncode != 0:
            raise LightGBMError(f"{os.path.basename(src)} failed to "
                                f"build:\n{proc.stdout}")
        os.replace(tmp, path)
    return path
