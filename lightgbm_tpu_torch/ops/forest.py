"""Forest traversal: the CUDA kernel and its plain PyTorch version.

Counterpart of the JAX package's fused forest kernel
(lightgbm_tpu/ops/stacked_predict.py:1048 ``forest_predict_pallas`` and
:1157 ``forest_predict_pallas_gpu``): feature-major bin codes ``[F, N]``
in, ``[N, K]`` f32 scores out (or ``[N, T]`` int32 leaf indices). The
TPU kernel finds each leaf through two one-hot matrix products; here a
thread walks each tree from its root (csrc/forest_predict.cu says why).

``forest_predict`` launches the kernel for CUDA tensors and runs
``forest_predict_plain`` for CPU tensors; there is no other route. The
plain version adds the same f32 values in the same order, so the two
agree bit for bit. The library is built by utils/cuda_build.py.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..utils import cuda_build
from ..utils.device import Counter
from ..utils.log import LightGBMError

# kernel launches since the last reset (the plain version never counts)
launches = Counter()


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


def _library():
    lib = cuda_build.library("forest_predict")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.forest_predict_scores.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                          i, p]
    lib.forest_predict_scores.restype = i
    lib.forest_predict_leaves.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.forest_predict_leaves.restype = i
    return lib


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

