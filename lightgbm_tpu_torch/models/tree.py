"""Decision tree model (host-side arrays + serialization).

The JAX package's ``models/tree.py``: the reference Tree
(include/LightGBM/tree.h:1-518, src/io/tree.cpp:209-355) as parallel
numpy-friendly lists, its v2 model text, its float64 host traversal,
``tree_from_record``, which builds a Tree from a grown TreeRecord, and
``record_arrays_from_tree``, its inverse for continued training.

- node i is created by split i; leaves are encoded as ``~leaf_index`` in
  child pointers (tree.h left_child_/right_child_ convention)
- decision_type bit flags: bit0 categorical, bit1 default_left,
  bits 2-3 missing_type (tree.h:14-15,183-201)
- thresholds are real-valued bin upper bounds (Tree::Split via
  RealThreshold; infinities clamped by Common::AvoidInf, common.h:661)
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..io.binning import MissingType
from ..utils import log

K_CATEGORICAL_MASK = 1
K_DEFAULT_LEFT_MASK = 2
_MAX_DOUBLE = 1e300


def avoid_inf(x: float) -> float:
    """Common::AvoidInf (common.h:661)."""
    if np.isnan(x):
        return 0.0
    return float(np.clip(x, -_MAX_DOUBLE, _MAX_DOUBLE))


class Tree:
    """Fixed-arity tree as parallel arrays."""

    def __init__(self, max_leaves: int):
        self.max_leaves = max_leaves
        self.num_leaves = 1
        self.num_cat = 0
        self.split_feature: List[int] = []     # [num_leaves-1] real feat idx
        self.split_gain: List[float] = []
        self.threshold_in_bin: List[int] = []
        self.threshold: List[float] = []
        self.decision_type: List[int] = []
        self.left_child: List[int] = []
        self.right_child: List[int] = []
        self.leaf_value: List[float] = [0.0]
        self.leaf_count: List[int] = [0]
        self.internal_value: List[float] = []
        self.internal_count: List[int] = []
        self.cat_boundaries: List[int] = [0]
        self.cat_threshold: List[int] = []
        self.shrinkage = 1.0
        # leaf -> (parent_node, is_left) for child-pointer fixups
        self._leaf_ptr = {0: None}

    # -- growth (host mirror of Tree::Split, tree.h:53) ---------------------

    def split(self, leaf: int, feature: int, threshold_bin: int,
              threshold_real: float, left_value: float, right_value: float,
              left_count: int, right_count: int, gain: float,
              missing_type: int, default_left: bool) -> int:
        dtype = (missing_type & 3) << 2
        if default_left:
            dtype |= K_DEFAULT_LEFT_MASK
        return self._add_node(leaf, feature, threshold_bin,
                              avoid_inf(threshold_real), dtype, left_value,
                              right_value, left_count, right_count, gain)

    def split_categorical(self, leaf: int, feature: int, cat_values,
                          left_value: float, right_value: float,
                          left_count: int, right_count: int, gain: float,
                          missing_type: int) -> int:
        """Tree::SplitCategorical (src/io/tree.cpp): the left set is a
        bitset over CATEGORY values, its words appended to cat_threshold;
        threshold_in_bin and threshold hold the split's index into
        cat_boundaries."""
        cat_values = sorted(int(v) for v in cat_values if v >= 0)
        words = [0] * (max(cat_values, default=0) // 32 + 1)
        for v in cat_values:
            words[v // 32] |= 1 << (v % 32)
        ci = self.num_cat
        self.cat_boundaries.append(self.cat_boundaries[-1] + len(words))
        self.cat_threshold.extend(words)
        self.num_cat += 1
        return self._add_node(leaf, feature, ci, float(ci),
                              K_CATEGORICAL_MASK | ((missing_type & 3) << 2),
                              left_value, right_value, left_count,
                              right_count, gain)

    def _add_node(self, leaf, feature, threshold_in_bin, threshold, dtype,
                  left_value, right_value, left_count, right_count,
                  gain) -> int:
        """The node that splits ``leaf``: the left child keeps the leaf's
        index, the right child takes the next one."""
        node = self.num_leaves - 1
        # fix parent pointer that referenced `leaf`
        ptr = self._leaf_ptr.get(leaf)
        if ptr is not None:
            pnode, is_left = ptr
            if is_left:
                self.left_child[pnode] = node
            else:
                self.right_child[pnode] = node
        self.split_feature.append(feature)
        self.split_gain.append(gain)
        self.threshold_in_bin.append(threshold_in_bin)
        self.threshold.append(threshold)
        self.decision_type.append(dtype)
        self.left_child.append(~leaf)
        self.right_child.append(~self.num_leaves)
        self.internal_value.append(
            self.leaf_value[leaf] if leaf < len(self.leaf_value) else 0.0)
        self.internal_count.append(left_count + right_count)
        new_leaf = self.num_leaves
        self._leaf_ptr[leaf] = (node, True)
        self._leaf_ptr[new_leaf] = (node, False)
        # left keeps slot `leaf`
        if leaf < len(self.leaf_value):
            self.leaf_value[leaf] = left_value
            self.leaf_count[leaf] = left_count
        self.leaf_value.append(right_value)
        self.leaf_count.append(right_count)
        self.num_leaves += 1
        return node

    # -- prediction (tree.h:212-266) ---------------------------------------

    def _decision(self, fval: float, node: int) -> int:
        dt = self.decision_type[node]
        if dt & K_CATEGORICAL_MASK:
            return self._categorical_decision(fval, node)
        missing_type = (dt >> 2) & 3
        if np.isnan(fval) and missing_type != MissingType.NAN:
            fval = 0.0
        if ((missing_type == MissingType.ZERO and
             -1e-35 <= fval <= 1e-35)
                or (missing_type == MissingType.NAN and np.isnan(fval))):
            if dt & K_DEFAULT_LEFT_MASK:
                return self.left_child[node]
            return self.right_child[node]
        if fval <= self.threshold[node]:
            return self.left_child[node]
        return self.right_child[node]

    def _categorical_decision(self, fval: float, node: int) -> int:
        if np.isnan(fval):
            return self.right_child[node]
        cat = int(fval)
        if cat < 0:
            return self.right_child[node]
        i = self.threshold_in_bin[node]  # cat index into cat_boundaries
        lo = self.cat_boundaries[i]
        hi = self.cat_boundaries[i + 1]
        for word_idx in range(lo, hi):
            pos = (word_idx - lo) * 32
            if pos <= cat < pos + 32:
                if (self.cat_threshold[word_idx] >> (cat - pos)) & 1:
                    return self.left_child[node]
        return self.right_child[node]

    def _traverse(self, X: np.ndarray) -> np.ndarray:
        """Vectorized level-synchronous traversal: all rows advance one
        node per pass (numpy gathers replace the per-row while loop the
        reference runs under OpenMP, tree.h:212-266)."""
        n = X.shape[0]
        if self.num_leaves == 1:
            return np.full(n, -1, np.int64)     # ~0: the single leaf
        feat = np.asarray(self.split_feature, np.int64)
        thresh = np.asarray(self.threshold, np.float64)
        dtyp = np.asarray(self.decision_type, np.int64)
        left = np.asarray(self.left_child, np.int64)
        right = np.asarray(self.right_child, np.int64)
        is_cat = (dtyp & K_CATEGORICAL_MASK) != 0
        def_left = (dtyp & K_DEFAULT_LEFT_MASK) != 0
        mtype = (dtyp >> 2) & 3
        cat_bound = np.asarray(self.cat_boundaries, np.int64)
        cat_words = np.asarray(self.cat_threshold, np.uint32)

        node = np.zeros(n, np.int64)
        active = np.arange(n)
        while active.size:
            cur = node[active]
            fval = X[active, feat[cur]]
            nan = np.isnan(fval)
            mt = mtype[cur]
            # numerical decision with missing handling (tree.h:183-201)
            fz = np.where(nan & (mt != MissingType.NAN), 0.0, fval)
            miss = ((mt == MissingType.ZERO)
                    & (fz >= -1e-35) & (fz <= 1e-35)) \
                | ((mt == MissingType.NAN) & nan)
            go_left = np.where(miss, def_left[cur], fz <= thresh[cur])
            if is_cat.any():
                cat_rows = is_cat[cur]
                if cat_rows.any():
                    cc = cur[cat_rows]
                    cv = fval[cat_rows]
                    ok = ~np.isnan(cv) & (cv >= 0)
                    cat = np.where(ok, cv, 0).astype(np.int64)
                    ci = np.asarray(self.threshold_in_bin,
                                    np.int64)[cc]
                    lo, hi = cat_bound[ci], cat_bound[ci + 1]
                    word = lo + cat // 32
                    in_range = ok & (word < hi)
                    bit = np.zeros(len(cc), bool)
                    if in_range.any():
                        w = cat_words[word[in_range]]
                        bit[in_range] = (
                            (w >> (cat[in_range] % 32)) & 1) != 0
                    go_left[cat_rows] = bit
            node[active] = np.where(go_left, left[cur], right[cur])
            active = active[node[active] >= 0]
        return node

    def predict(self, X: np.ndarray) -> np.ndarray:
        """Raw leaf values per row (vectorized traversal)."""
        leaves = ~self._traverse(np.asarray(X, np.float64))
        return np.asarray(self.leaf_value, np.float64)[leaves]

    def predict_leaf_index(self, X: np.ndarray) -> np.ndarray:
        return (~self._traverse(np.asarray(X, np.float64))).astype(np.int32)


    # -- serialization (src/io/tree.cpp:209-243) ----------------------------

    def to_string(self) -> str:
        nl = self.num_leaves
        buf = [f"num_leaves={nl}", f"num_cat={self.num_cat}"]

        def arr(name, a, fmt=str):
            buf.append(f"{name}=" + " ".join(fmt(x) for x in a))

        arr("split_feature", self.split_feature[:nl - 1])
        arr("split_gain", self.split_gain[:nl - 1], _fmt_float)
        arr("threshold", self.threshold[:nl - 1], _fmt_double)
        arr("decision_type", self.decision_type[:nl - 1])
        arr("left_child", self.left_child[:nl - 1])
        arr("right_child", self.right_child[:nl - 1])
        arr("leaf_value", self.leaf_value[:nl], _fmt_double)
        arr("leaf_count", self.leaf_count[:nl])
        arr("internal_value", self.internal_value[:nl - 1], _fmt_float)
        arr("internal_count", self.internal_count[:nl - 1])
        if self.num_cat > 0:
            arr("cat_boundaries", self.cat_boundaries[:self.num_cat + 1])
            arr("cat_threshold", self.cat_threshold)
        buf.append(f"shrinkage={_fmt_float(self.shrinkage)}")
        buf.append("")
        return "\n".join(buf)

    @classmethod
    def from_string(cls, s: str) -> "Tree":
        """Tree parse ctor (src/io/tree.cpp:377+ semantics)."""
        kv = {}
        for line in s.strip().splitlines():
            if "=" in line:
                k, v = line.split("=", 1)
                kv[k.strip()] = v.strip()
        t = cls(int(kv["num_leaves"]))
        t.num_leaves = int(kv["num_leaves"])
        t.num_cat = int(kv.get("num_cat", 0))

        def ints(key, default=None):
            if key not in kv or kv[key] == "":
                return default if default is not None else []
            return [int(float(x)) for x in kv[key].split()]

        def floats(key, default=None):
            if key not in kv or kv[key] == "":
                return default if default is not None else []
            return [float(x) for x in kv[key].split()]

        nl = t.num_leaves
        t.split_feature = ints("split_feature")
        t.split_gain = floats("split_gain")
        t.threshold = floats("threshold")
        t.decision_type = ints("decision_type", [0] * (nl - 1))
        t.left_child = ints("left_child")
        t.right_child = ints("right_child")
        t.leaf_value = floats("leaf_value", [0.0])
        t.leaf_count = ints("leaf_count", [0] * nl)
        t.internal_value = floats("internal_value", [0.0] * (nl - 1))
        t.internal_count = ints("internal_count", [0] * (nl - 1))
        t.threshold_in_bin = [
            int(th) if (dt & K_CATEGORICAL_MASK) else 0
            for th, dt in zip(t.threshold, t.decision_type)]
        if t.num_cat > 0:
            t.cat_boundaries = ints("cat_boundaries")
            t.cat_threshold = ints("cat_threshold")
        t.shrinkage = float(kv.get("shrinkage", 1))
        return t



def _fmt_float(x) -> str:
    return np.format_float_positional(
        np.float32(x), unique=True, trim="0") if np.isfinite(x) else str(x)


def _fmt_double(x) -> str:
    if not np.isfinite(x):
        return str(x)
    return repr(float(x))


def record_arrays_from_tree(tree: Tree, real_to_inner: dict, mappers,
                            max_leaves: int) -> dict:
    """The inverse of ``tree_from_record`` (the JAX package's
    tree.py:492-562): a host Tree as TreeRecord-shaped numpy arrays in
    the bin space of ``mappers``, for continued training
    (GBDT::LoadModelFromString, gbdt_model_text.cpp:339-450, rebuilds
    its model the same way). Node i is split i; the leaf it split is
    found by descending left children to a leaf, since a re-split leaf
    keeps its index in its left child. Thresholds are bin upper bounds,
    so ``value_to_bin`` maps them back exactly on the same mappers; a
    categorical node's category bitset becomes its bins' bitset."""
    L = max_leaves
    nl = tree.num_leaves
    if nl > L:
        log.fatal(f"Loaded tree has {nl} leaves > num_leaves cap {L}; "
                  "raise num_leaves to continue training this model")
    s = max(L - 1, 1)
    out = {
        "num_leaves": np.int32(nl),
        "split_leaf": np.full(s, -1, np.int32),
        "split_feature": np.zeros(s, np.int32),
        "split_bin": np.zeros(s, np.int32),
        "split_gain": np.zeros(s, np.float32),
        "split_default_left": np.zeros(s, bool),
        "leaf_output": np.zeros(L, np.float32),
        "leaf_count": np.zeros(L, np.float32),
        "leaf_sum_g": np.zeros(L, np.float32),
        "leaf_sum_h": np.zeros(L, np.float32),
        "internal_value": np.zeros(s, np.float32),
        "internal_count": np.zeros(s, np.float32),
        "split_is_cat": np.zeros(s, bool),
        "split_cat_words": np.zeros((s, 8), np.int32),
    }
    for i in range(nl - 1):
        c = tree.left_child[i]
        while c >= 0:
            c = tree.left_child[c]
        out["split_leaf"][i] = ~c
        inner = real_to_inner.get(tree.split_feature[i])
        if inner is None:
            log.fatal(f"Loaded model splits on feature "
                      f"{tree.split_feature[i]} which is trivial/unused in "
                      "the new training data")
        out["split_feature"][i] = inner
        if tree.decision_type[i] & K_CATEGORICAL_MASK:
            ci = tree.threshold_in_bin[i]
            lo, hi = tree.cat_boundaries[ci], tree.cat_boundaries[ci + 1]
            words = np.zeros(8, np.uint32)
            for cat, b in mappers[inner].categorical_2_bin.items():
                w = cat // 32
                if lo + w < hi and b < 256 and cat >= 0 \
                        and (tree.cat_threshold[lo + w] >> (cat % 32)) & 1:
                    words[b // 32] |= np.uint32(1 << (b % 32))
            out["split_is_cat"][i] = True
            out["split_cat_words"][i] = words.astype(np.int32)
        else:
            out["split_bin"][i] = int(mappers[inner].value_to_bin(
                np.asarray([tree.threshold[i]]))[0])
            out["split_default_left"][i] = bool(
                tree.decision_type[i] & K_DEFAULT_LEFT_MASK)
        out["split_gain"][i] = tree.split_gain[i]
        out["internal_value"][i] = tree.internal_value[i]
        out["internal_count"][i] = tree.internal_count[i]
    out["leaf_output"][:nl] = tree.leaf_value[:nl]
    out["leaf_count"][:nl] = tree.leaf_count[:nl]
    return out


def tree_from_record(rec: dict, mappers, real_features, max_leaves: int
                     ) -> Tree:
    """A host Tree from a grown record's host arrays
    (``TreeRecord.to_numpy``; the JAX package's tree.py:564): thresholds
    become the split bins' real upper bounds, features their real
    column indices, and a categorical split's bin bitset the set of its
    bins' categories (``bin_2_categorical``)."""
    nl = int(rec["num_leaves"])
    t = Tree(max_leaves)
    for i in range(nl - 1):
        leaf = int(rec["split_leaf"][i])
        if leaf < 0:
            break
        feat = int(rec["split_feature"][i])
        tbin = int(rec["split_bin"][i])
        mapper = mappers[feat]
        if bool(rec["split_is_cat"][i]):
            words = np.asarray(rec["split_cat_words"][i]).astype(np.int64)
            cats = [c for b, c in enumerate(mapper.bin_2_categorical)
                    if (words[b // 32] >> (b % 32)) & 1]
            node = t.split_categorical(
                leaf=leaf, feature=int(real_features[feat]),
                cat_values=cats, left_value=0.0, right_value=0.0,
                left_count=0, right_count=0,
                gain=float(rec["split_gain"][i]),
                missing_type=mapper.missing_type)
        else:
            node = t.split(leaf=leaf, feature=int(real_features[feat]),
                           threshold_bin=tbin,
                           threshold_real=mapper.bin_to_value(tbin),
                           left_value=0.0, right_value=0.0, left_count=0,
                           right_count=0, gain=float(rec["split_gain"][i]),
                           missing_type=mapper.missing_type,
                           default_left=bool(rec["split_default_left"][i]))
        t.internal_value[node] = float(rec["internal_value"][i])
        t.internal_count[node] = int(round(float(rec["internal_count"][i])))
    for leaf in range(nl):
        t.leaf_value[leaf] = float(rec["leaf_output"][leaf])
        t.leaf_count[leaf] = int(round(float(rec["leaf_count"][leaf])))
    return t
