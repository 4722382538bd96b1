"""The record of one grown tree (the JAX package's ``ops/grower.py``
``TreeRecord``); models/tree.py builds a host Tree from it."""
from __future__ import annotations

from typing import NamedTuple


class TreeRecord(NamedTuple):
    """Tensors of one tree, in split order (split i's right child is
    leaf i + 1)."""
    num_leaves: object             # int: leaves actually grown
    split_leaf: object             # [L-1] int32 parent leaf (-1 unused)
    split_feature: object          # [L-1] int32 inner feature
    split_bin: object              # [L-1] int32 threshold bin
    split_gain: object             # [L-1] f32
    split_default_left: object     # [L-1] bool
    leaf_output: object            # [L] f32
    leaf_count: object             # [L] f32
    leaf_sum_g: object             # [L] f32
    leaf_sum_h: object             # [L] f32
    internal_value: object         # [L-1] f32 parent output at split time
    internal_count: object         # [L-1] f32
    split_is_cat: object           # [L-1] bool
    split_cat_words: object        # [L-1, 8] int32 left-set bin bitset

    def to_numpy(self) -> dict:
        """Host arrays keyed by field name (one copy per field)."""
        out = {}
        for k, v in self._asdict().items():
            out[k] = v.cpu().numpy() if hasattr(v, "cpu") else v
        return out
