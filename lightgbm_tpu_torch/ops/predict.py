"""Score updates from leaf ids: the leaf gather-add (K3).

Counterpart of the JAX package's ``ops/predict.py``:
``add_leaf_outputs`` (:102) with ``leaf_gather_pallas`` (:64), reference
ScoreUpdater::AddScore (score_updater.hpp:17-123). ``add_leaf_outputs``
adds ``table[leaf_ids]`` to the scores in place: it launches
csrc/leaf_gather.cu for CUDA tensors and runs ``add_leaf_outputs_plain``
for CPU tensors; there is no other route. Ids outside ``[0, L)`` add
nothing (the two JAX paths disagree there: the TPU kernel adds 0.0,
the XLA gather wraps -1 to the last entry and clamps high ids to it).
Both versions round the same two
f32 operations, the table's shrinkage product (done by the caller) and
the add, so they agree bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import cuda_build
from ..utils.device import Counter
from ..utils.log import LightGBMError

MAX_LEAVES = 4096        # the table lives in shared memory

# kernel launches since the last reset (the plain version never counts)
launches = Counter()


def _library():
    lib = cuda_build.library("leaf_gather")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.leaf_gather_add_launch.argtypes = [p, p, p, i, ll, p]
    lib.leaf_gather_add_launch.restype = i
    return lib


def replay_partition(rec, bins_t: torch.Tensor, meta) -> torch.Tensor:
    """Leaf ids [N] int32 of the rows of ``bins_t`` [F, N] in a grown
    tree, by replaying its splits in order (the JAX package's
    predict.py:22; split i's right child is leaf i + 1)."""
    from .partition import apply_split
    leaf_ids = torch.zeros(bins_t.shape[1], dtype=torch.int32,
                           device=bins_t.device)
    for i in range(rec.num_leaves - 1):
        f = int(rec.split_feature[i])
        leaf_ids = apply_split(
            leaf_ids, bins_t[f].to(torch.int32), int(rec.split_leaf[i]),
            i + 1, int(rec.split_bin[i]), bool(rec.split_default_left[i]),
            int(meta.missing_type[f]), int(meta.default_bin[f]),
            int(meta.num_bin[f]))
    return leaf_ids


def add_leaf_outputs_plain(scores: torch.Tensor, leaf_ids: torch.Tensor,
                           table: torch.Tensor) -> torch.Tensor:
    """scores[i] += table[leaf_ids[i]] in place, for ids in [0, L)."""
    L = table.shape[0]
    ok = (leaf_ids >= 0) & (leaf_ids < L)
    gathered = table[leaf_ids.clamp(0, L - 1).to(torch.int64)]
    scores.copy_(torch.where(ok, scores + gathered, scores))
    return scores


def add_leaf_outputs(scores: torch.Tensor, leaf_ids: torch.Tensor,
                     table: torch.Tensor) -> torch.Tensor:
    """scores [N] f32 += table [L] f32 at leaf_ids [N] int32, in place;
    ids outside [0, L) add nothing. Returns ``scores``."""
    if scores.device.type == "cpu":
        return add_leaf_outputs_plain(scores, leaf_ids, table)
    if scores.device.type != "cuda":
        raise LightGBMError(f"no leaf-gather kernel for {scores.device}")
    L = table.shape[0]
    if not 1 <= L <= MAX_LEAVES:
        raise LightGBMError(f"leaf table of {L} entries; the kernel takes "
                            f"1..{MAX_LEAVES}")
    for name, t, dtype in (("scores", scores, torch.float32),
                           ("leaf_ids", leaf_ids, torch.int32),
                           ("table", table, torch.float32)):
        if t.device != scores.device:
            raise LightGBMError(f"{name} is on {t.device}, scores on "
                                f"{scores.device}")
        if t.dtype != dtype or not t.is_contiguous():
            raise LightGBMError(f"{name} must be contiguous {dtype}")
    if leaf_ids.shape != scores.shape:
        raise LightGBMError("leaf_ids and scores differ in shape")
    with torch.cuda.device(scores.device):
        err = _library().leaf_gather_add_launch(
            scores.data_ptr(), leaf_ids.data_ptr(), table.data_ptr(), L,
            scores.numel(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise LightGBMError(f"leaf gather kernel failed: CUDA error {err}")
    launches.add()
    return scores
