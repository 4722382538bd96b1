"""Leaf-membership updates (the JAX package's ``ops/partition.py``).

Reference DataPartition::Split + Bin::Split
(src/treelearner/data_partition.hpp:109-166, src/io/dense_bin.hpp Split):
rows keep a flat ``leaf_ids[N]`` assignment that a split updates with a
masked select. Numerical splits only; EFB bundles are not ported, so a
feature's column is its own bin row.
"""
from __future__ import annotations

import torch

from .split import MISSING_NAN, MISSING_ZERO


def row_goes_right(bin_col, threshold_bin, default_left, missing_type,
                   default_bin, num_bin):
    """Binned decision of one split (dense_bin.hpp Split): rows in the
    NaN bin (MissingType.NAN) or the zero bin (MissingType.ZERO) go to
    the default side; the others go right when bin > threshold. The
    split parameters may be scalars or tensors that broadcast with
    ``bin_col``."""
    is_missing = (((missing_type == MISSING_NAN) & (bin_col == num_bin - 1))
                  | ((missing_type == MISSING_ZERO)
                     & (bin_col == default_bin)))
    return torch.where(is_missing, ~torch.as_tensor(default_left),
                       bin_col > threshold_bin)


def apply_split(leaf_ids, bin_col, leaf, new_leaf, threshold_bin,
                default_left, missing_type, default_bin, num_bin):
    """Send leaf ``leaf``'s right-side rows to ``new_leaf``: the left
    child keeps the parent's index (Tree::Split numbering)."""
    right = row_goes_right(bin_col, threshold_bin, default_left,
                           missing_type, default_bin, num_bin)
    return torch.where((leaf_ids == leaf) & right, new_leaf, leaf_ids)
