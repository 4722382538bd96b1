"""Forest traversal: the CUDA kernel, its plain PyTorch version, the build.

Counterpart of the JAX package's fused forest kernel
(lightgbm_tpu/ops/stacked_predict.py:1048 ``forest_predict_pallas`` and
:1157 ``forest_predict_pallas_gpu``): feature-major bin codes ``[F, N]``
in, ``[N, K]`` f32 scores out (or ``[N, T]`` int32 leaf indices). The
TPU kernel finds each leaf through two one-hot matrix products; here a
thread walks each tree from its root (csrc/forest_predict.cu says why).

``forest_predict`` launches the kernel for CUDA tensors and runs
``forest_predict_plain`` for CPU tensors; there is no other route. The
plain version adds the same f32 values in the same order, so the two
agree bit for bit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..utils.device import Counter
from ..utils.log import LightGBMError

SOURCE = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc",
                      "forest_predict.cu")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                         "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel launches since the last reset (the plain version never counts)
launches = Counter()

_lib = None
_lib_lock = threading.Lock()


class Forest(NamedTuple):
    """The per-node tables the walk reads (built by
    ops/stacked_predict.py ``walk_tables``)."""
    nodes: torch.Tensor       # [T, S, 4] int32: feature, left, right, offset
    dec: torch.Tensor         # [T, S, Wn] uint8: go-left per local code
    leaf: torch.Tensor        # [T, L] f32
    root: torch.Tensor        # [T] int32: 0, or -1 for a single-leaf tree
    root_host: np.ndarray     # [T] int32, root on the host
    depth: np.ndarray         # [T] nodes on the longest root-leaf path
    num_class: int
    num_features: int

    def to(self, device) -> "Forest":
        return self._replace(nodes=self.nodes.to(device),
                             dec=self.dec.to(device),
                             leaf=self.leaf.to(device),
                             root=self.root.to(device))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise LightGBMError("nvcc not found: the forest kernel is built "
                            "from csrc/forest_predict.cu on first use")
    return path


def build_library() -> Tuple[str, float, str]:
    """Compile csrc/forest_predict.cu for sm_90a unless a library built
    from the same source and flags exists. Returns (path, seconds spent
    compiling, nvcc's report)."""
    with open(SOURCE, "rb") as fh:
        src = fh.read()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    path = os.path.join(BUILD_DIR, f"forest_predict_{digest[:16]}.so")
    if os.path.exists(path):
        return path, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise LightGBMError(f"nvcc failed on {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, path)
    return path, seconds, proc.stdout + proc.stderr


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            path, _, _ = build_library()
            lib = ctypes.CDLL(path)
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.forest_predict_scores.argtypes = [p, p, p, p, p, p, i, i, i,
                                                  i, i, i, i, p]
            lib.forest_predict_scores.restype = i
            lib.forest_predict_leaves.argtypes = [p, p, p, p, p, i, i, i, i,
                                                  i, p]
            lib.forest_predict_leaves.restype = i
            _lib = lib
    return _lib


def _check(codes_t: torch.Tensor, forest: Forest, first: int,
           last: int) -> None:
    if codes_t.dtype != torch.int32 or codes_t.dim() != 2:
        raise LightGBMError(f"codes must be [F, N] int32, got "
                            f"{tuple(codes_t.shape)} {codes_t.dtype}")
    if codes_t.shape[0] != forest.num_features:
        raise LightGBMError(f"codes have {codes_t.shape[0]} features, the "
                            f"forest reads {forest.num_features}")
    if not 0 <= first <= last <= forest.leaf.shape[0]:
        raise LightGBMError(f"tree range [{first}, {last}) outside "
                            f"[0, {forest.leaf.shape[0]}]")
    for name, t, dtype in (("nodes", forest.nodes, torch.int32),
                           ("dec", forest.dec, torch.uint8),
                           ("leaf", forest.leaf, torch.float32),
                           ("root", forest.root, torch.int32)):
        if t.device != codes_t.device:
            raise LightGBMError(f"forest.{name} is on {t.device}, codes "
                                f"on {codes_t.device}")
        if t.dtype != dtype:
            raise LightGBMError(f"forest.{name} must be {dtype}")


def forest_predict(codes_t: torch.Tensor, forest: Forest, first: int,
                   last: int, leaf_mode: bool = False) -> torch.Tensor:
    """Trees [first, last) over codes_t [F, N] int32 -> [N, K] f32 scores
    (tree t adds to class t % K), or [N, last - first] int32 leaf indices
    with ``leaf_mode``. CUDA tensors launch the kernel; CPU tensors run
    the plain version."""
    _check(codes_t, forest, first, last)
    if codes_t.device.type == "cpu":
        return forest_predict_plain(codes_t, forest, first, last, leaf_mode)
    if codes_t.device.type != "cuda":
        raise LightGBMError(f"no forest kernel for {codes_t.device}")
    for name, t in (("codes", codes_t), ("nodes", forest.nodes),
                    ("dec", forest.dec), ("leaf", forest.leaf),
                    ("root", forest.root)):
        if not t.is_contiguous():
            raise LightGBMError(f"{name} must be contiguous")
    if forest.nodes.data_ptr() % 16:
        raise LightGBMError("forest.nodes must be 16-byte aligned")
    n = codes_t.shape[1]
    if n >= 2 ** 31:
        raise LightGBMError(f"{n} rows in one launch; chunk the rows")
    _, s, wn = forest.dec.shape
    dev = codes_t.device
    lib = _library()
    if leaf_mode:
        out = torch.empty((n, last - first), dtype=torch.int32, device=dev)
    else:
        out = torch.empty((n, forest.num_class), dtype=torch.float32,
                          device=dev)
    if n == 0:
        return out
    # the library launches on the current device: make the tensors' own
    # current for the call, and the caller's current again after it
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if leaf_mode:
            err = lib.forest_predict_leaves(
                codes_t.data_ptr(), forest.nodes.data_ptr(),
                forest.dec.data_ptr(), forest.root.data_ptr(),
                out.data_ptr(), n, s, wn, first, last, stream)
        else:
            err = lib.forest_predict_scores(
                codes_t.data_ptr(), forest.nodes.data_ptr(),
                forest.dec.data_ptr(), forest.leaf.data_ptr(),
                forest.root.data_ptr(), out.data_ptr(), n, s, wn,
                forest.leaf.shape[1], first, last, forest.num_class, stream)
    if err != 0:
        raise LightGBMError(f"forest kernel launch failed: CUDA error {err}")
    launches.add()
    return out


def forest_predict_plain(codes_t: torch.Tensor, forest: Forest, first: int,
                         last: int, leaf_mode: bool = False,
                         ) -> torch.Tensor:
    """The same walk in plain PyTorch: all rows advance one node per
    step, tree by tree, adding leaf values in model order."""
    dev = codes_t.device
    n = codes_t.shape[1]
    rows = torch.arange(n, device=dev)
    k = forest.num_class
    if leaf_mode:
        out = torch.empty((n, last - first), dtype=torch.int32, device=dev)
    else:
        out = torch.zeros((n, k), dtype=torch.float32, device=dev)
    for t in range(first, last):
        node = torch.full((n,), int(forest.root_host[t]), dtype=torch.int64,
                          device=dev)
        nodes = forest.nodes[t].long()
        dec = forest.dec[t]
        for _ in range(int(forest.depth[t])):
            cur = node.clamp(min=0)
            nd = nodes[cur]
            code = codes_t[nd[:, 0], rows].long()
            left = dec[cur, code - nd[:, 3]] != 0
            node = torch.where(node >= 0,
                               torch.where(left, nd[:, 1], nd[:, 2]), node)
        leaf = ~node
        if leaf_mode:
            out[:, t - first] = leaf.int()
        else:
            out[:, t % k] += forest.leaf[t][leaf]
    return out

