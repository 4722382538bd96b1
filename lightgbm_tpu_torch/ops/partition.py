"""Leaf-membership updates (the JAX package's ``ops/partition.py``).

Reference DataPartition::Split + Bin::Split
(src/treelearner/data_partition.hpp:109-166, src/io/dense_bin.hpp Split):
rows keep a flat ``leaf_ids[N]`` assignment that a split updates with a
masked select. A feature's column is its own bin row, or under EFB
bundles (io/efb.py) decoded from its bundle's column (``member_column``).
"""
from __future__ import annotations

import torch

from .split import MISSING_NAN, MISSING_ZERO, NCAT_WORDS


def member_column(bins_t, feat: int, meta) -> torch.Tensor:
    """Feature ``feat``'s bin column [N] int32 from the bin matrix
    (the JAX package's ``member_column``, partition.py:22-33): its row,
    or under bundles its bundle's row decoded, a value in the member's
    range [offset, offset + num_bin) as value - offset and any other
    value (another member's, or 0: every member at its default) as the
    member's default bin."""
    if not meta.bundled:
        return bins_t[feat].to(torch.int32)
    col = bins_t[int(meta.bundle[feat])].to(torch.int32)
    off, nb = int(meta.offset[feat]), int(meta.num_bin[feat])
    return torch.where((col >= off) & (col < off + nb), col - off,
                       int(meta.default_bin[feat]))


def cat_bit_left(bin_col, cat_words):
    """True where the bin's bit is set in the left-set bitset: bin_col
    [..., N] int32, cat_words [..., NCAT_WORDS] int32 (leading dims
    matching bin_col's). Bins past the bitset have no bit."""
    b = bin_col.to(torch.int64)
    word = torch.gather(torch.as_tensor(cat_words, device=b.device)
                        .to(torch.int64).expand(*b.shape[:-1], -1),
                        -1, (b >> 5).clamp(max=NCAT_WORDS - 1))
    return (((word >> (b & 31)) & 1) != 0) & (b < NCAT_WORDS * 32)


def row_goes_right(bin_col, threshold_bin, default_left, missing_type,
                   default_bin, num_bin, is_cat=False, cat_words=None):
    """Binned decision of one split (dense_bin.hpp Split): rows in the
    NaN bin (MissingType.NAN) or the zero bin (MissingType.ZERO) go to
    the default side; the others go right when bin > threshold. The
    split parameters may be scalars or tensors that broadcast with
    ``bin_col``. A categorical split (``is_cat``, with its
    ``cat_words``, dense_bin.hpp SplitCategorical) ignores the missing
    rule: bins whose bit is set go left, every other bin (unseen
    categories, NaN) goes right."""
    is_missing = (((missing_type == MISSING_NAN) & (bin_col == num_bin - 1))
                  | ((missing_type == MISSING_ZERO)
                     & (bin_col == default_bin)))
    right = torch.where(is_missing, ~torch.as_tensor(default_left),
                        bin_col > threshold_bin)
    if cat_words is not None:
        right = torch.where(torch.as_tensor(is_cat, device=right.device),
                            ~cat_bit_left(bin_col, cat_words), right)
    return right


def apply_split(leaf_ids, bin_col, leaf, new_leaf, threshold_bin,
                default_left, missing_type, default_bin, num_bin,
                is_cat=False, cat_words=None):
    """Send leaf ``leaf``'s right-side rows to ``new_leaf``: the left
    child keeps the parent's index (Tree::Split numbering)."""
    right = row_goes_right(bin_col, threshold_bin, default_left,
                           missing_type, default_bin, num_bin, is_cat,
                           cat_words)
    return torch.where((leaf_ids == leaf) & right, new_leaf, leaf_ids)
