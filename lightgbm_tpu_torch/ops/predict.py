"""Score updates from leaf ids: the leaf gather-add (K3).

Counterpart of the JAX package's ``ops/predict.py``:
``add_leaf_outputs`` (:102) with ``leaf_gather_pallas`` (:64), reference
ScoreUpdater::AddScore (score_updater.hpp:17-123). ``add_leaf_outputs``
sets ``scores = fma(table[leaf_ids], shrink, scores)`` in place: it
launches csrc/leaf_gather.cu for CUDA tensors and runs
``add_leaf_outputs_plain`` for CPU tensors; there is no other route.
Ids outside ``[0, L)`` add nothing (the two JAX paths disagree there:
the TPU kernel adds 0.0, the XLA gather wraps -1 to the last entry and
clamps high ids to it). The shrinkage rides the add as one fused
multiply-add, one rounding, as XLA contracts the JAX package's
``scores + leaf_output * shrink``; the kernel's ``fmaf`` and the plain
version's exact emulation (ops/f32math.py) agree bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import cuda_build
from ..utils.device import Counter, on_device
from ..utils.log import LightGBMError

MAX_LEAVES = 4096        # the table lives in shared memory

# kernel launches since the last reset (the plain version never counts)
launches = Counter()
_launch = None


def _launch_fn():
    """The library's launch function, its types bound once."""
    global _launch
    if _launch is None:
        fn = cuda_build.library("leaf_gather").leaf_gather_add_launch
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, i, ctypes.c_float, ll, p]
        fn.restype = i
        _launch = fn
    return _launch


def replay_partition(rec, bins_t: torch.Tensor, meta) -> torch.Tensor:
    """Leaf ids [N] int32 of the rows of ``bins_t`` [F, N] in a grown
    tree, by replaying its splits in order (the JAX package's
    predict.py:22; split i's right child is leaf i + 1), categorical
    ones by their bitsets."""
    from .partition import apply_split
    leaf_ids = torch.zeros(bins_t.shape[1], dtype=torch.int32,
                           device=bins_t.device)
    for i in range(rec.num_leaves - 1):
        f = int(rec.split_feature[i])
        leaf_ids = apply_split(
            leaf_ids, bins_t[f].to(torch.int32), int(rec.split_leaf[i]),
            i + 1, int(rec.split_bin[i]), bool(rec.split_default_left[i]),
            int(meta.missing_type[f]), int(meta.default_bin[f]),
            int(meta.num_bin[f]), bool(rec.split_is_cat[i]),
            rec.split_cat_words[i])
    return leaf_ids


def add_leaf_outputs_plain(scores: torch.Tensor, leaf_ids: torch.Tensor,
                           table: torch.Tensor,
                           shrink: float = 1.0) -> torch.Tensor:
    """scores[i] = fma(table[leaf_ids[i]], shrink, scores[i]) in place,
    for ids in [0, L)."""
    from .f32math import fma
    L = table.shape[0]
    ok = (leaf_ids >= 0) & (leaf_ids < L)
    gathered = table[leaf_ids.clamp(0, L - 1).to(torch.int64)]
    scores.copy_(torch.where(ok, fma(gathered, shrink, scores), scores))
    return scores


def add_leaf_outputs(scores: torch.Tensor, leaf_ids: torch.Tensor,
                     table: torch.Tensor, shrink: float = 1.0) -> torch.Tensor:
    """scores [N] f32 = fma(table [L] f32 at leaf_ids [N] int32, shrink
    (taken as f32), scores), in place; ids outside [0, L) add nothing.
    Returns ``scores``."""
    if scores.device.type == "cpu":
        return add_leaf_outputs_plain(scores, leaf_ids, table, shrink)
    if scores.device.type != "cuda":
        raise LightGBMError(f"no leaf-gather kernel for {scores.device}")
    dev = scores.device
    L = table.shape[0]
    if not 1 <= L <= MAX_LEAVES:
        raise LightGBMError(f"leaf table of {L} entries; the kernel takes "
                            f"1..{MAX_LEAVES}")
    if leaf_ids.device != dev or table.device != dev:
        raise LightGBMError(f"leaf_ids on {leaf_ids.device}, table on "
                            f"{table.device}, scores on {dev}")
    if (scores.dtype != torch.float32 or leaf_ids.dtype != torch.int32
            or table.dtype != torch.float32):
        raise LightGBMError("scores and table must be float32, leaf_ids "
                            "int32")
    if not (scores.is_contiguous() and leaf_ids.is_contiguous()
            and table.is_contiguous()):
        raise LightGBMError("scores, leaf_ids and table must be contiguous")
    if leaf_ids.shape != scores.shape:
        raise LightGBMError("leaf_ids and scores differ in shape")
    with on_device(dev):
        err = _launch_fn()(
            scores.data_ptr(), leaf_ids.data_ptr(), table.data_ptr(), L,
            float(shrink), scores.numel(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise LightGBMError(f"leaf gather kernel failed: CUDA error {err}")
    launches.add()
    return scores
