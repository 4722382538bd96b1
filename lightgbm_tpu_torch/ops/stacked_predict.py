"""Whole-model prediction: host-built tables, device binning, the forest
kernel.

The JAX package's ``ops/stacked_predict.py`` builds, on the host, one
decision table per tree node over a global bin layout of every feature
(``_scan_nodes``, ``_rebuild_tables``, ``_stack_trees``, ``_node_table``):
a node's table is its own decision evaluated at one representative value
per bin, so the device agrees with the host walk by construction
(missing values, default-left, the zero band and categorical bitsets).
That build is copied here as numpy, bit for bit. The device side
differs: instead of the TPU's one-hot matrix products the port walks
each tree (ops/forest.py). The decision rows are evaluated straight into
a ``[T, S, Wn]`` table (``dec``, the plain version's), and
``compact_tables`` turns each row into an 8-byte record for the kernel:
a threshold on the feature's local code, or a bitset row, plus the
decisions of two codes the kernel stages apart (the feature's last,
NaN, code and its zero band), checked against the row at every code.
The TPU layout (``W [Wtot, T, S]``, the ancestor matrix and the leaf
targets) is built only on request (``jax_layout``), and ``walk_tables``
turns the JAX package's own W into the walk's tables.

Rows are binned on the device when they are f32-exact and every feature
is numerical, by the forest kernel itself (K4 from rows,
``forest_ops.forest_predict_from_x``: one launch a row chunk), else on
the host in float64 (``_bin_rows``) and walked from their codes. A batch
is cut into chunks of its serve bucket (ops/predict_cache.py: a power of
two, at most ``ROW_CHUNK``) and the last chunk is padded to it, as the
JAX stacker pads (its ``ops/stacked_predict.py:649, :707``); the pad
rows are sliced off. A model consults the predict registry once per
geometry and bucket (``_dispatch``); on a card its score calls replay
one CUDA graph over the registry entry's staging (``_replay``).
Continued training extends a clone of the stack (``extend``) instead of
rebuilding it.
"""
from __future__ import annotations

import copy
import threading
from collections import OrderedDict
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from . import forest as forest_ops
from . import predict_cache
from .forest import codes_from_x   # noqa: F401  (re-exported)
from ..io.binning import MissingType
from ..obs import reqlog
from ..utils import log
from ..utils.device import Counter, capture_graph

# decision_type bit layout (models/tree.py, mirroring tree.h)
K_CATEGORICAL_MASK = 1
K_DEFAULT_LEFT_MASK = 2

_ZERO_EPS = 1e-35
# per-feature table-width cap: categorical features whose bitsets cover
# more distinct categories than this fall back to the host path
MAX_FEATURE_WIDTH = 1024
# rows per forest-kernel launch: bounds the codes and staging tensors
ROW_CHUNK = 1 << 18
# serving graphs a model keeps per registry entry, one per tree range
# (first, ntree): the full model's and a few num_iteration cuts
MAX_GRAPHS = 8

# models that could not be stacked and are scored by the host walk
fallbacks = Counter()


class StackedModel:
    """Host-built stacked tables for a list of trees, their device
    copies, and ``predict``."""

    def __init__(self, trees: List, num_features: int, num_class: int,
                 device: torch.device, serve_bucket: Optional[int] = None):
        """``serve_bucket`` is the owning booster's ``tpu_serve_bucket``
        (None: the process default, ops/predict_cache.py)."""
        self.num_class = num_class
        self.num_trees = len(trees)
        self.device = device
        self._serve_policy = serve_bucket
        # (geometry key) -> [registry entry, this model's CUDA graphs by
        # tree range (first, ntree)]
        self._memo: dict = {}
        self._memo_lock = threading.Lock()
        self.ok = True
        try:
            self._build(trees, num_features)
            predict_cache.count_stack(len(trees))
        except _FallbackError as e:
            log.warning("stacked predict unavailable (%s); "
                        "host prediction path will be used", e)
            fallbacks.add()
            self.ok = False

    # -- host-side build (copied from the JAX package) -----------------------

    def _build(self, trees: List, num_features: int) -> None:
        F = num_features
        self._F = F
        feats, lefts, rights = _node_arrays(
            [t.split_feature[:t.num_leaves - 1] for t in trees],
            [t.left_child[:t.num_leaves - 1] for t in trees],
            [t.right_child[:t.num_leaves - 1] for t in trees])
        depth = _tree_depths(lefts, rights)   # before any walk over nodes
        L = max([t.num_leaves for t in trees] + [2])
        S = L - 1

        # 1. per-feature edges / category sets from every node
        self._thr_sets: List[set] = [set() for _ in range(F)]
        self._cat_sets: List[set] = [set() for _ in range(F)]
        self._zero_mt = np.zeros(F, bool)
        self._is_cat = np.zeros(F, bool)
        self._scan_nodes(trees)

        # 2. per-feature representative values + binning data
        reps = self._rebuild_tables()
        self._reps = reps
        self._S, self._L = S, L

        # 3. the JAX package's cap on its [Wtot, T, S] int8 decision
        # matrix, kept so that both packages stack the same models; the
        # port never builds that matrix
        w_bytes = self._Wtot * len(trees) * S
        if w_bytes > (2 << 30):
            raise _FallbackError(f"W matrix {w_bytes >> 20} MB")

        # 4. the walk's tables, each node's decisions evaluated straight
        # into dec[t, s, :width of its feature]; the binning tables
        dec, leaf_val = _decision_rows(trees, reps, S, L, self._rep_sizes)
        self._nodes = (feats, lefts, rights, depth)
        self._set_tables(dec, leaf_val)

    def _set_tables(self, dec: np.ndarray, leaf_val: np.ndarray) -> None:
        """The host decision rows and leaf values, the walk's tables and
        the device-binning tables from them, on the model's device."""
        feats, lefts, rights, depth = self._nodes
        self._dec, self._leaf_val = dec, leaf_val
        self.forest = _forest(feats, lefts, rights, depth, self._offsets,
                              self._rep_sizes, dec, leaf_val,
                              num_class=self.num_class, device=self.device,
                              bands=self._zero_bands(self._reps))
        self.edges = (edge_tensors(self._E_f32, self._off32, self._nan_slot,
                                   self.device)
                      if self._dev_bin_ok else None)

    # -- incremental stacking (the JAX package's :288-396) ------------------

    def clone_for_extend(self) -> "StackedModel":
        """A shallow copy whose ``extend()`` cannot perturb a reader of
        the original: the copy-on-write half of GBDT._stacked_model's
        publish protocol. The containers ``extend`` mutates in place are
        duplicated; the tables are only ever reassigned. The copy starts
        with an empty memo: a graph holds the addresses of the tables it
        was captured with, so none is carried onto new tables."""
        new = copy.copy(self)
        new._thr_sets = [set(x) for x in self._thr_sets]
        new._cat_sets = [set(x) for x in self._cat_sets]
        new._zero_mt = self._zero_mt.copy()
        new._is_cat = self._is_cat.copy()
        new._memo = {}
        new._memo_lock = threading.Lock()
        return new

    def extend(self, new_trees: List) -> bool:
        """Append ``new_trees``, evaluating only their nodes.

        An old node's decision row is copied into the new code layout
        instead of re-evaluated (the JAX package's argument): a new
        threshold splits an old bin into sub-bins wholly inside it, and an
        old node decides alike across an old bin (its threshold is an
        edge; the zero band is a bin of its own whose sub-bins stay in
        it); new categories fall in the old "other" slot, which every old
        bitset sends right. So the new code j of feature f takes the old
        row at ``_feature_codes(new rep j, old edges, old categories)``.

        Returns False when the extension cannot be hosted (a feature-role
        conflict, the width or byte caps); the model is then untouched and
        the caller rebuilds. The memo is emptied on success: graphs of the
        old tables are never replayed on the new ones."""
        new_trees = list(new_trees)
        if not self.ok:
            return False
        if not new_trees:
            return True
        saved = ([set(x) for x in self._thr_sets],
                 [set(x) for x in self._cat_sets],
                 self._zero_mt.copy(), self._is_cat.copy(),
                 self._edges, self._cats, self._rep_sizes, self._offsets,
                 self._Wtot, self._dev_bin_ok, self._reps,
                 getattr(self, "_E_f32", None),
                 getattr(self, "_nan_slot", None),
                 getattr(self, "_off32", None))
        old_edges, old_cats = self._edges, self._cats
        old_dec, T_old = self._dec, self.num_trees
        feats, lefts, rights, depth = self._nodes
        try:
            self._scan_nodes(new_trees)
            reps = self._rebuild_tables()
            self._reps = reps
            L = max([self._L] + [t.num_leaves for t in new_trees])
            S = L - 1
            T = T_old + len(new_trees)
            if self._Wtot * T * S > (2 << 30):
                raise _FallbackError(
                    f"W matrix {(self._Wtot * T * S) >> 20} MB")
            Wn = max(int(np.max(self._rep_sizes, initial=1)), 1)
            dec = np.zeros((T, S, Wn), np.uint8)
            used = np.zeros(old_dec.shape[:2], bool)
            feat_all = np.zeros(old_dec.shape[:2], np.int64)
            for t, feat in enumerate(feats):
                feat_all[t, :feat.size] = feat
                used[t, :feat.size] = True
            for f in np.unique(feat_all[used]):
                src = _feature_codes(reps[f], old_edges[f], old_cats[f])
                m = used & (feat_all == f)
                dec[:T_old, :old_dec.shape[1], :src.size][m] = \
                    old_dec[m][:, src]
            dn, leafn = _decision_rows(new_trees, reps, S, L,
                                       self._rep_sizes)
            dec[T_old:] = dn
            leaf_val = np.concatenate([
                np.pad(self._leaf_val, ((0, 0), (0, L - self._L))), leafn])
        except _FallbackError as e:
            (self._thr_sets, self._cat_sets, self._zero_mt, self._is_cat,
             self._edges, self._cats, self._rep_sizes, self._offsets,
             self._Wtot, self._dev_bin_ok, self._reps, self._E_f32,
             self._nan_slot, self._off32) = saved
            log.info("incremental stack fell back (%s); rebuilding", e)
            return False
        nf, nl, nr = _node_arrays(
            [t.split_feature[:t.num_leaves - 1] for t in new_trees],
            [t.left_child[:t.num_leaves - 1] for t in new_trees],
            [t.right_child[:t.num_leaves - 1] for t in new_trees])
        self._nodes = (feats + nf, lefts + nl, rights + nr,
                       np.concatenate([depth, _tree_depths(nl, nr)]))
        self._S, self._L = S, L
        self.num_trees = T
        self._set_tables(dec, leaf_val)
        with self._memo_lock:
            self._memo = {}
        predict_cache.count_extend(len(new_trees))
        return True

    def _zero_bands(self, reps: List[np.ndarray]) -> List:
        """Per feature, the local codes (lo, hi) whose representatives lie
        in the reference's zero band |x| <= 1e-35 (tree.h:188), for the
        features a zero-as-missing node reads; None elsewhere."""
        bands: List = [None] * self._F
        for f in np.flatnonzero(self._zero_mt & ~self._is_cat):
            with np.errstate(invalid="ignore"):
                inside = np.flatnonzero(np.abs(reps[f][:-1]) <= _ZERO_EPS)
            if inside.size:
                bands[f] = (int(inside[0]), int(inside[-1]))
        return bands

    def jax_layout(self, trees: List):
        """The JAX package's stacked tables of ``trees`` (the trees this
        model was built from): ``(W [Wtot, T, S] int8, P [T, S, L] int8,
        tgt [T, L] f32, leaf values [T, L] f32)``, for parity checks.
        Prediction never builds them."""
        return self._stack_trees(trees, self._reps, self._S, self._L)

    def _scan_nodes(self, trees: List) -> None:
        """Accumulate every node's thresholds / category bitsets into
        the per-feature sets (the union layout the decision tables are
        binned against). Raises on shapes the stacker cannot host."""
        F = self._F
        for t in trees:
            for s in range(t.num_leaves - 1):
                f = t.split_feature[s]
                if f >= F:
                    raise _FallbackError(f"node feature {f} >= {F}")
                dt = t.decision_type[s]
                if dt & K_CATEGORICAL_MASK:
                    self._is_cat[f] = True
                    ci = t.threshold_in_bin[s]
                    lo, hi = t.cat_boundaries[ci], t.cat_boundaries[ci + 1]
                    for wi in range(lo, hi):
                        w = int(t.cat_threshold[wi]) & 0xFFFFFFFF
                        base = (wi - lo) * 32
                        while w:
                            b = (w & -w).bit_length() - 1
                            self._cat_sets[f].add(base + b)
                            w &= w - 1
                else:
                    self._thr_sets[f].add(float(t.threshold[s]))
                    if (dt >> 2) & 3 == MissingType.ZERO:
                        self._zero_mt[f] = True
        if np.any(self._is_cat & (np.array(
                [len(s) for s in self._thr_sets]) > 0)):
            raise _FallbackError("feature used both numerically and "
                                 "categorically")

    def _rebuild_tables(self) -> List[np.ndarray]:
        """Per-feature representative values, bin edges, table offsets
        and the device-binning arrays, all derived from the accumulated
        threshold/category sets. Returns the rep list.

        Numerical layout: [m closed-right bins][overflow][NaN].
        Categorical layout: [known cats][other][negative/NaN]."""
        F = self._F
        self._edges: List[Optional[np.ndarray]] = [None] * F
        self._cats: List[Optional[np.ndarray]] = [None] * F
        reps: List[np.ndarray] = []
        widths = np.zeros(F, np.int64)
        for f in range(F):
            if self._is_cat[f]:
                cs = np.array(sorted(self._cat_sets[f]), np.float64)
                if cs.size > MAX_FEATURE_WIDTH:
                    raise _FallbackError(
                        f"categorical feature {f} has {cs.size} "
                        f"distinct categories (> {MAX_FEATURE_WIDTH})")
                self._cats[f] = cs
                other = (cs.max() + 1.0) if cs.size else 1.0
                rep = np.concatenate([cs, [other, -1.0]])
            else:
                thr = set(self._thr_sets[f])
                if self._zero_mt[f]:
                    # isolate the reference's zero band |x| <= 1e-35
                    # (tree.h:188) into its own bin so a representative
                    # speaks for every value it covers
                    thr |= {np.nextafter(-_ZERO_EPS, -np.inf), _ZERO_EPS}
                edges = np.asarray(sorted(thr), np.float64)
                if edges.size > MAX_FEATURE_WIDTH:
                    raise _FallbackError(
                        f"feature {f} has {edges.size} thresholds")
                self._edges[f] = edges
                over = (np.nextafter(edges[-1], np.inf)
                        if edges.size else 0.0)
                rep = np.concatenate([edges, [over, np.nan]])
            # widths bucketed to 32 as in the JAX package, so the global
            # code layout (offsets) is the same in both packages
            widths[f] = -(-rep.size // 32) * 32
            reps.append(rep)
        self._rep_sizes = np.array([r.size for r in reps], np.int64)
        self._offsets = np.concatenate([[0], np.cumsum(widths)])
        self._Wtot = int(self._offsets[-1])

        # device binning (numerical features only): f32 edges rounded
        # DOWN so an f32 row compares exactly like f64 against the f64
        # threshold (x <= t  <=>  x <= largest-f32 <= t, for
        # f32-representable x)
        self._dev_bin_ok = not any(c is not None for c in self._cats)
        if self._dev_bin_ok:
            m_max = max((e.size for e in self._edges if e is not None),
                        default=0)
            E = np.full((F, max(m_max, 1)), np.inf, np.float32)
            for f in range(F):
                e = self._edges[f]
                if e is None or e.size == 0:
                    continue
                # clip into f32 range BEFORE the cast: thresholds near
                # ±DBL_MAX would otherwise overflow to ±inf. The clipped
                # edge keeps the compare semantics: any finite f32
                # x <= f32max < huge-t (left stays left), and the bump
                # below handles the negative side like any other edge
                # that is not f32-representable
                f32i = np.finfo(np.float32)
                ef = e.clip(f32i.min, f32i.max).astype(np.float32)
                bump = ef.astype(np.float64) > e
                ef[bump] = np.nextafter(ef[bump], -np.inf)
                E[f, :e.size] = ef
            self._E_f32 = E
            self._nan_slot = np.array(
                [self._offsets[f] + self._rep_sizes[f] - 1
                 for f in range(F)],
                np.int32)
            self._off32 = self._offsets[:F].astype(np.int32)
        return reps

    def _stack_trees(self, trees: List, reps: List[np.ndarray],
                     S: int, L: int):
        """Decision tables / ancestor matrices / leaf values for
        ``trees`` against the current table layout, in the JAX package's
        layout (``jax_layout``)."""
        T = len(trees)
        Wtot = self._Wtot
        W = np.zeros((Wtot, T, S), np.int8)
        P = np.zeros((T, S, L), np.int8)
        tgt = np.full((T, L), 1e9, np.float32)   # padded leaves: no match
        leaf_val = np.zeros((T, L), np.float32)
        for ti, t in enumerate(trees):
            nl = t.num_leaves
            leaf_val[ti, :nl] = np.asarray(t.leaf_value[:nl], np.float32)
            for s in range(nl - 1):
                f = t.split_feature[s]
                o = self._offsets[f]
                W[o:o + self._rep_sizes[f], ti, s] = _node_table(
                    t, s, reps[f])
            # DFS: signed ancestor matrix + per-leaf left-count target
            if nl == 1:
                tgt[ti, 0] = 0.0
                continue
            stack2 = [(0, [])]           # node, ancestor (node, sign) list
            while stack2:
                node, anc = stack2.pop()
                for child, sign in ((t.left_child[node], 1),
                                    (t.right_child[node], -1)):
                    a2 = anc + [(node, sign)]
                    if child < 0:
                        lf = ~child
                        # E = (#left-ancestors gone left)
                        #   - (#right-ancestors gone left) == nLeft
                        # exactly when every ancestor decision points
                        # at this leaf
                        tgt[ti, lf] = sum(1 for _, sg in a2 if sg > 0)
                        for sn, sg in a2:
                            P[ti, sn, lf] = sg
                    else:
                        stack2.append((child, a2))
        return W, P, tgt, leaf_val

    # -- prediction ---------------------------------------------------------

    def _bin_rows(self, X: np.ndarray) -> np.ndarray:
        """[N, F] float64 -> global one-hot column codes [N, Fm] int32
        (model features only; surplus input columns are ignored)."""
        N = X.shape[0]
        Fm = len(self._offsets) - 1
        codes = np.zeros((N, Fm), np.int32)
        nanc = np.full(N, np.nan)
        for f in range(Fm):
            x = X[:, f] if f < X.shape[1] else nanc
            codes[:, f] = self._offsets[f] + _feature_codes(
                x, self._edges[f], self._cats[f])
        return codes

    def _device_rows(self, X: np.ndarray) -> Optional[np.ndarray]:
        """The model features of ``X`` as f32 rows ``[N, Fm]`` for the
        device binning, or None when the host must bin them: a
        categorical feature, too few columns, or f64 values that are not
        f32-exact (probed on 64 rows first, so true f64 data pays no full
        scan). A rule decided before any launch. f32 input is taken as it
        is, with no scan."""
        Fm = len(self._offsets) - 1
        if not self._dev_bin_ok or X.shape[1] < Fm:
            return None
        if X.dtype == np.float32:
            return np.ascontiguousarray(X[:, :Fm])
        # overflow in these casts is EXPECTED for data that is not
        # f32-exact (values beyond f32 range become inf, _f32_exact
        # rejects them and the host binning path runs)
        with np.errstate(over="ignore"):
            probe = X[:64, :Fm]
            if not _f32_exact(probe, probe.astype(np.float32)):
                return None
            Xf = X[:, :Fm].astype(np.float32)
            return Xf if _f32_exact(X[:, :Fm], Xf) else None

    def _dispatch(self, first: int, ntree: int, chunk: int, pred_leaf: bool,
                  dev_bin: bool) -> list:
        """This model's memo entry ``[registry entry, graphs]`` for the
        launch of trees [first, ntree) over chunks of ``chunk`` rows: the
        registry (ops/predict_cache.py) is consulted once per (model,
        geometry), so its hits count reuse across models. The key holds
        what shapes the launch plan and the staging: the code layout and
        the tables' shape (the JAX package's key), the route, the bucket
        and the plan itself (which the walk's features, code and record
        widths and tree range decide). The plan records the chunks the
        range spans, not the range, so ranges of one plan share the entry
        and its staging; a graph bakes its range in, so ``graphs`` holds
        one per (first, ntree) (``_replay``)."""
        plan = forest_ops.plan_for(self.forest, chunk, first, ntree,
                                   pred_leaf)
        key = ("forest", str(self.device),
               tuple(int(o) for o in self._offsets), self._S, self._L,
               self.num_class, bool(pred_leaf), bool(dev_bin),
               self._E_f32.shape[1] if dev_bin else 0, chunk, plan)
        with self._memo_lock:
            got = self._memo.get(key)
            if got is None:
                Fm = len(self._offsets) - 1
                got = self._memo[key] = [predict_cache.get(
                    key, lambda: _Entry(plan, chunk, Fm, self.num_class,
                                        self.device)), OrderedDict()]
            return got

    def predict(self, X: np.ndarray, first: int = 0,
                ntree: Optional[int] = None,
                pred_leaf: bool = False) -> np.ndarray:
        """Raw scores [K, N] float64 (or leaf indices [N, ntree-first]
        int32) of trees [first, ntree). ``X`` is float64, or float32 as
        the C API hands f32 input over (binned on the device as it is).

        Rows the device bins go through K4 from rows; on a card, score
        calls replay this model's CUDA graph over its registry entry's
        staging (``_replay``): every bucket up to ``ROW_CHUNK``, each chunk
        of a larger batch. Leaf indices, host-binned rows and the CPU
        launch eagerly."""
        ntree = self.num_trees if ntree is None else min(ntree,
                                                         self.num_trees)
        first = min(first, ntree)
        X = np.asarray(X)
        if X.dtype != np.float32:
            X = np.ascontiguousarray(X, np.float64)
        rows = self._device_rows(X)
        dev_bin = rows is not None
        if rows is None:
            rows = self._bin_rows(np.asarray(X, np.float64))
        N = X.shape[0]
        K = self.num_class
        # the serve bucket, clamped to the row chunk; the clamped width
        # is the one the request rode (obs/reqlog.py)
        chunk = max(1, min(ROW_CHUNK, predict_cache.serve_bucket_rows(
            N, self._serve_policy)))
        reqlog.note_bucket(chunk)
        if N == 0 or first == ntree:
            return (np.zeros((N, ntree - first), np.int32) if pred_leaf
                    else np.zeros((K, N), np.float64))
        memo = self._dispatch(first, ntree, chunk, pred_leaf, dev_bin)
        if dev_bin and not pred_leaf and self.device.type == "cuda":
            return self._replay(memo, rows, first, ntree).T.astype(
                np.float64)
        parts = []
        for c0 in range(0, N, chunk):
            part = rows[c0:c0 + chunk]
            if part.shape[0] < chunk:
                # the rows are scored one by one: pad rows (copies of
                # the last row, valid codes) only add rows to slice
                part = np.pad(part, ((0, chunk - part.shape[0]), (0, 0)),
                              mode="edge")
            if dev_bin:
                parts.append(forest_ops.forest_predict_from_x(
                    torch.from_numpy(part).to(self.device), self.edges,
                    self.forest, first, ntree, leaf_mode=pred_leaf))
            else:
                parts.append(forest_ops.forest_predict(
                    torch.from_numpy(np.ascontiguousarray(part.T)).to(
                        self.device), self.forest, first, ntree,
                    leaf_mode=pred_leaf))
        out = torch.cat(parts)[:N].cpu().numpy()
        return out if pred_leaf else out.T.astype(np.float64)

    def _replay(self, memo: list, rows: np.ndarray, first: int,
                ntree: int) -> np.ndarray:
        """[N, K] f32 scores of f32 ``rows`` through the memo's registry
        entry: per chunk the rows go into its pinned staging, this
        model's graph of trees [first, ntree) (the copy in, K4 from rows,
        the copy out) replays, and the scores are read from its pinned
        result once its event has passed. A range's first call launches
        the three eagerly (its warm-up) and captures the graph after; a
        memo entry keeps the ``MAX_GRAPHS`` ranges used last. The entry's
        lock keeps the threads that share its staging apart, from the
        copy in to the read."""
        entry, graphs = memo
        rng = (first, ntree)
        out = np.empty((rows.shape[0], self.num_class), np.float32)
        with entry.lock:
            st = entry.staging()
            for c0 in range(0, rows.shape[0], entry.bucket):
                nr = min(entry.bucket, rows.shape[0] - c0)
                st.x_np[:nr] = rows[c0:c0 + nr]
                graph = graphs.get(rng)
                if graph is None:
                    # capture: ok(self) — the graph is kept in this
                    # model's memo: the tables it reads are this model's
                    run = lambda: self._stage_and_launch(st, first, ntree)
                    run()
                    graphs[rng] = capture_graph(run, self.device)
                    while len(graphs) > MAX_GRAPHS:
                        graphs.popitem(last=False)
                else:
                    graphs.move_to_end(rng)
                    graph.replay()      # counts its K4 launch
                st.done.record()
                st.done.synchronize()
                out[c0:c0 + nr] = st.out_np[:nr]
        return out

    def _stage_and_launch(self, st: "_Staging", first: int,
                          ntree: int) -> None:
        """The staged rows up, K4 from rows into the static scores, the
        scores down: what a serving graph holds (its copies as memcpy
        nodes)."""
        st.x_dev.copy_(st.x_host, non_blocking=True)
        forest_ops.forest_predict_from_x(st.x_dev, self.edges, self.forest,
                                         first, ntree, out=st.out_dev)
        st.out_host.copy_(st.out_dev, non_blocking=True)


class _Staging(NamedTuple):
    """A serving entry's buffers on a card: pinned rows, the static
    device rows and scores, pinned scores, and the event a call waits on."""
    x_host: torch.Tensor
    x_np: np.ndarray
    x_dev: torch.Tensor
    out_dev: torch.Tensor
    out_host: torch.Tensor
    out_np: np.ndarray
    done: object


class _Entry:
    """A predict registry value (ops/predict_cache.py): what one serve
    bucket's launch needs that no model's tables decide: its plan, and on
    a card its staging (made at first use; pinned host memory needs a
    card). Models of one geometry share it; ``lock`` orders their use of
    the staging."""

    def __init__(self, plan: "forest_ops.ForestPlan", bucket: int, Fm: int,
                 K: int, device: torch.device):
        self.plan = plan
        self.bucket = bucket
        self._shape = (bucket, Fm, K)
        # the staging's bytes on a card, pinned host and device (the
        # registry's byte bound)
        self.nbytes = (2 * 4 * bucket * (Fm + K)
                       if device.type == "cuda" else 0)
        self.device = device
        self.lock = threading.Lock()
        self._staging: Optional[_Staging] = None

    def staging(self) -> _Staging:
        """The buffers, made on first use (the caller holds ``lock``)."""
        if self._staging is None:
            bucket, Fm, K = self._shape
            f32 = torch.float32
            x_host = torch.zeros((bucket, Fm), dtype=f32, pin_memory=True)
            out_host = torch.zeros((bucket, K), dtype=f32, pin_memory=True)
            self._staging = _Staging(
                x_host=x_host, x_np=x_host.numpy(),
                x_dev=torch.zeros((bucket, Fm), dtype=f32,
                                  device=self.device),
                out_dev=torch.zeros((bucket, K), dtype=f32,
                                    device=self.device),
                out_host=out_host, out_np=out_host.numpy(),
                done=torch.cuda.Event())
        return self._staging


class _FallbackError(Exception):
    pass


def walk_tables(W: np.ndarray, leaf: np.ndarray, offsets: np.ndarray,
                rep_sizes: np.ndarray, split_feature: Sequence,
                left_child: Sequence, right_child: Sequence, *,
                num_class: int, device) -> forest_ops.Forest:
    """The forest kernel's tables from the JAX package's stacked decision
    tables ``W [Wtot, T, S]`` and each tree's node arrays (convert.py).

    Node s of tree t reads feature f = split_feature[t][s]; its decision
    at local code j is ``W[offsets[f] + j, t, s]``, stored contiguously
    as ``dec[t, s, j]``. Child pointers are validated here (every node
    reached once from the root, leaves in range), so the kernel's walk
    always ends."""
    Wtot, T, S = W.shape
    L = leaf.shape[1]
    F = len(offsets) - 1
    feats, lefts, rights = _node_arrays(split_feature, left_child,
                                        right_child)
    for t, feat in enumerate(feats):
        ns = feat.size
        if ns and (ns > S or ns + 1 > L or feat.min() < 0
                   or feat.max() >= F):
            log.fatal(f"tree {t}: {ns} nodes on features outside the "
                      f"stacked layout")
    depth = _tree_depths(lefts, rights)
    dec = np.zeros((T, S, max(int(np.max(rep_sizes, initial=1)), 1)),
                   np.uint8)
    feat_all = np.zeros((T, S), np.int64)
    used = np.zeros((T, S), bool)
    for t, feat in enumerate(feats):
        feat_all[t, :feat.size] = feat
        used[t, :feat.size] = True
    for f in np.unique(feat_all[used]):
        m = used & (feat_all == f)
        o, w = int(offsets[f]), int(rep_sizes[f])
        dec[m, :w] = W[o:o + w][:, m].T
    return _forest(feats, lefts, rights, depth, offsets, rep_sizes, dec,
                   leaf, num_class=num_class, device=device)


def _decision_rows(trees: List, reps: List[np.ndarray], S: int, L: int,
                   rep_sizes: np.ndarray):
    """(dec [T, S, Wn] uint8, leaf values [T, L] f32) of ``trees``: each
    node's decisions at its feature's representatives."""
    T = len(trees)
    dec = np.zeros((T, S, max(int(np.max(rep_sizes, initial=1)), 1)),
                   np.uint8)
    leaf_val = np.zeros((T, L), np.float32)
    for ti, t in enumerate(trees):
        nl = t.num_leaves
        leaf_val[ti, :nl] = np.asarray(t.leaf_value[:nl], np.float32)
        for s in range(nl - 1):
            rep = reps[t.split_feature[s]]
            dec[ti, s, :rep.size] = _node_table(t, s, rep)
    return dec, leaf_val


def _node_arrays(split_feature: Sequence, left_child: Sequence,
                 right_child: Sequence):
    """Each tree's node arrays as int64 numpy."""
    return tuple([np.asarray(a, np.int64) for a in arrays]
                 for arrays in (split_feature, left_child, right_child))


def _forest(feats, lefts, rights, depth: np.ndarray, offsets: np.ndarray,
            widths: np.ndarray, dec: np.ndarray, leaf: np.ndarray, *,
            num_class: int, device, bands=None) -> forest_ops.Forest:
    """The plain version's tables (node records [T, S, 4] = feature,
    left, right, table offset of the feature; ``dec``; leaf values) on
    the host, and the kernel's compact tables (``compact_tables``) on
    ``device``."""
    T, S, _ = dec.shape
    nodes = np.zeros((T, S, 4), np.int32)
    root = np.zeros(T, np.int32)
    for t, feat in enumerate(feats):
        if feat.size == 0:
            root[t] = -1                # ~0: the single leaf
            continue
        nodes[t, :feat.size] = np.stack(
            [feat, lefts[t], rights[t], offsets[feat]], axis=1)
    leaf = np.ascontiguousarray(leaf, np.float32)
    return forest_ops.Forest(
        nodes=torch.from_numpy(nodes), dec=torch.from_numpy(dec),
        leaf=torch.from_numpy(leaf), root_host=root, depth=depth,
        num_class=int(num_class), num_features=len(offsets) - 1,
        walk=compact_tables(feats, lefts, rights, dec, widths, leaf, root,
                            offsets, bands=bands, device=device))


def compact_tables(feats, lefts, rights, dec: np.ndarray, widths,
                   leaf: np.ndarray, root: np.ndarray, offsets, *,
                   bands=None, device) -> forest_ops.Walk:
    """The kernel's tables (``forest_ops.Walk``, csrc/forest_predict.cu
    says how it reads them) from each tree's node arrays and the decision
    rows ``dec [T, S, Wn]`` (node s of tree t at local code j of its
    feature: ``dec[t, s, j]``, 1 = left; ``widths[f]`` codes a feature).

    A feature's last code (NaN; a categorical feature's negative/NaN
    code) is staged apart, and so is its zero band where ``bands[f]``
    names one (local codes lo..hi) that every node of the feature decides
    alike. A node whose row, on the other codes, is a step (left up to a
    code, right above it) becomes that threshold; any other row a bitset
    row over the feature's codes. Records are 8 bytes where the model's
    shape fits their fields (children in int16, a staged row within 64 KB,
    2**13 bitset words a tree), 16 otherwise. Every record is decoded
    again and checked against its row at every code of its feature; a
    mismatch raises."""
    return _compact_tables(feats, lefts, rights, dec, widths, leaf, root,
                           offsets, bands, None, device)


def _compact_tables(feats, lefts, rights, dec: np.ndarray, widths,
                    leaf: np.ndarray, root: np.ndarray, offsets, bands,
                    wide: Optional[bool], device) -> forest_ops.Walk:
    """``compact_tables`` with 16-byte records (``wide``), 8-byte ones
    (``wide=False``, where they fit) or the narrowest that fit (None):
    the other record width chip_smoke.py times and the tests check."""
    T, S, _ = dec.shape
    L = leaf.shape[1]
    widths = np.asarray(widths, np.int64)
    feat_all = np.zeros((T, S), np.int64)
    left_all = np.zeros((T, S), np.int64)
    right_all = np.zeros((T, S), np.int64)
    on = np.zeros((T, S), bool)
    for t, feat in enumerate(feats):
        k = feat.size
        feat_all[t, :k], left_all[t, :k] = feat, lefts[t]
        right_all[t, :k], on[t, :k] = rights[t], True
    used = np.unique(feat_all[on])
    slot_of = np.full(len(widths), -1, np.int64)
    slot_of[used] = np.arange(used.size)
    w = widths[used]
    band = np.full((used.size, 2), -1, np.int64)
    meta = np.zeros((T, S), np.int64)   # flags; payload set below
    pay = np.zeros((T, S), np.int64)
    bit_rows = []                       # (t, s, words) of bitset nodes
    for u, f in enumerate(used):
        m = on & (feat_all == f)
        wf = int(w[u])
        rows = dec[m][:, :wf]
        if rows.max(initial=0) > 1:
            log.fatal(f"feature {f}: a decision row holds values other "
                      f"than 0 and 1")
        ordinary = np.ones(wf, bool)
        ordinary[wf - 1] = False
        b = bands[f] if bands is not None else None
        if b is not None and 0 <= b[0] <= b[1] < wf - 1 and (
                rows[:, b[0]:b[1] + 1] == rows[:, b[0]:b[0] + 1]).all():
            band[u] = b
            ordinary[b[0]:b[1] + 1] = False
        o_idx = np.flatnonzero(ordinary)
        r_o = rows[:, o_idx]
        k = r_o.sum(1)
        step = (r_o == (np.arange(o_idx.size)[None, :] < k[:, None])).all(1)
        thr1 = np.where(k > 0, o_idx[np.maximum(k - 1, 0)] + 1
                        if o_idx.size else 0, 0)
        fl = rows[:, wf - 1].astype(np.int64)
        if band[u, 0] >= 0:
            fl |= rows[:, band[u, 0]].astype(np.int64) << 1
        meta[m] = fl | (~step).astype(np.int64) << 2
        pay[m] = np.where(step, thr1, 0)
        if (~step).any():
            packed = np.packbits(rows[~step].astype(bool), axis=1,
                                 bitorder="little")
            nw = -(-wf // 32)
            words = np.zeros((packed.shape[0], nw * 4), np.uint8)
            words[:, :packed.shape[1]] = packed
            ts, ss = np.nonzero(m)
            sel = ~step
            bit_rows += list(zip(ts[sel], ss[sel],
                                 words.view("<u4").reshape(-1, nw)))
    # bitset rows: each tree's in node order, the trees' areas in order
    bit_rows.sort(key=lambda e: (e[0], e[1]))
    counts = np.zeros(T, np.int64)
    for t, s, row in bit_rows:
        pay[t, s] = counts[t]
        counts[t] += row.size
    bits_base = np.concatenate([[0], np.cumsum(counts)[:-1]])
    bits = (np.concatenate([row for _, _, row in bit_rows])
            if bit_rows else np.zeros(1, np.uint32))
    code_bytes = 1 if int(w.max(initial=1)) <= 255 else 2
    fits8 = (S <= 1 << 15 and L <= 1 << 15
             and used.size * code_bytes <= 1 << 16
             and int(pay.max(initial=0)) < 1 << 13)
    if wide is None:
        wide = not fits8
    elif not wide and not fits8:
        log.fatal("the model's shape does not fit 8-byte records")
    if int(pay.max(initial=0)) >= 1 << 29:
        log.fatal("a tree's bitset rows exceed 2**29 words")
    meta |= pay << 3
    offset = np.where(on, slot_of[feat_all], 0) * code_bytes
    left_all = np.where(on, left_all, 0)
    right_all = np.where(on, right_all, 0)
    C = -(-T // forest_ops.LANES)
    pad = C * forest_ops.LANES - T
    if wide:
        rec = np.stack([left_all, right_all, offset, meta], axis=2)
        rec = np.pad(rec.astype(np.uint32).view(np.int32),
                     ((0, pad), (0, 0), (0, 0)))
        rec = rec.reshape(C, forest_ops.LANES, S, 4).transpose(0, 2, 1, 3)
    else:
        lo = (left_all & 0xFFFF) | (right_all & 0xFFFF) << 16
        hi = offset | meta << 16
        rec = np.pad((lo | hi << 32).astype(np.uint64).view(np.int64),
                     ((0, pad), (0, 0)))
        rec = rec.reshape(C, forest_ops.LANES, S).transpose(0, 2, 1)
    leaf_c = np.pad(leaf, ((0, pad), (0, 0))).reshape(
        C, forest_ops.LANES, L).transpose(0, 2, 1)
    # a last chunk of m <= 16 trees: its spare columns copy them, so that
    # the spare lanes walk (tree, row) pairs
    tail = forest_ops.LANES - pad if pad >= forest_ops.LANES // 2 else 0
    if tail:
        copy = np.arange(forest_ops.LANES) % tail
        rec = rec.copy()
        leaf_c = leaf_c.copy()
        rec[-1] = rec[-1][:, copy]
        leaf_c[-1] = leaf_c[-1][:, copy]
    feat_tab = np.stack(
        [used, np.asarray(offsets, np.int64)[used], w,
         np.where(band[:, 0] >= 0, band[:, 0] | band[:, 1] << 16, -1)],
        axis=1).astype(np.int32).reshape(-1, 4)
    walk = forest_ops.Walk(
        feat=torch.from_numpy(feat_tab),
        rec=torch.from_numpy(np.ascontiguousarray(rec)),
        leaf=torch.from_numpy(np.ascontiguousarray(leaf_c)),
        bits=torch.from_numpy(bits.view(np.int32)),
        bits_base=torch.from_numpy(bits_base.astype(np.int32)),
        root=torch.from_numpy(np.asarray(root, np.int32)),
        code_bytes=code_bytes, tail=tail)
    check_compact(walk, dec, feats, lefts, rights)
    return walk.to(device)


def _records(walk: forest_ops.Walk, T: int):
    """(left, right, feature slot, meta) [T, S] int64 decoded from the
    packed, tree-interleaved records, as the kernel decodes them."""
    rec = walk.rec.numpy()
    if walk.rec_bytes == 16:
        f = rec.transpose(0, 2, 1, 3).reshape(-1, rec.shape[1], 4)[:T]
        u = f.view(np.uint32).astype(np.int64)
        return (f[..., 0].astype(np.int64), f[..., 1].astype(np.int64),
                u[..., 2] // walk.code_bytes, u[..., 3])
    r = rec.transpose(0, 2, 1).reshape(-1, rec.shape[1])[:T].view(np.uint64)
    lo, hi = r & 0xFFFFFFFF, r >> 32
    return ((lo & 0xFFFF).astype(np.uint16).view(np.int16).astype(np.int64),
            (lo >> 16).astype(np.uint16).view(np.int16).astype(np.int64),
            (hi & 0xFFFF).astype(np.int64) // walk.code_bytes,
            (hi >> 16).astype(np.int64))


def check_compact(walk: forest_ops.Walk, dec: np.ndarray, feats, lefts,
                  rights) -> None:
    """Every record of ``walk`` (host tensors) decides as its decision
    row at every code of its feature, as the kernel stages the codes,
    and holds the node's children and feature; raises otherwise."""
    T = dec.shape[0]
    if walk.tail:
        copy = np.arange(forest_ops.LANES) % walk.tail
        for name in ("rec", "leaf"):
            last = getattr(walk, name).numpy()[-1]
            if not np.array_equal(last, last[:, copy]):
                log.fatal(f"the last chunk's spare {name} columns are not "
                          f"copies of its trees")
    left, right, slot, meta = _records(walk, T)
    feat_tab = walk.feat.numpy().astype(np.int64)
    bits = walk.bits.numpy().view(np.uint32)
    base = walk.bits_base.numpy().astype(np.int64)
    nan_v = (1 << 8 * walk.code_bytes) - 1
    on = np.zeros(left.shape, bool)
    for t, feat in enumerate(feats):
        k = feat.size
        on[t, :k] = True
        if not (np.array_equal(left[t, :k], lefts[t])
                and np.array_equal(right[t, :k], rights[t])
                and np.array_equal(feat_tab[slot[t, :k], 0], feat)):
            log.fatal(f"tree {t}: compact records lose a child or feature")
    for u, (f, _, wf, b) in enumerate(feat_tab):
        ts, ss = np.nonzero(on & (slot == u))
        staged = np.arange(wf)
        staged[wf - 1] = nan_v
        if b >= 0:
            staged[b & 0xFFFF:(b >> 16) + 1] = nan_v - 1
        mt = meta[ts, ss][:, None]
        pay = mt >> 3
        code = np.minimum(staged, wf - 1)[None, :]
        word = bits[np.minimum(base[ts][:, None] + pay + (code >> 5),
                               bits.size - 1)]
        got = np.where(staged == nan_v, mt & 1,
                       np.where(staged == nan_v - 1, mt >> 1 & 1,
                                np.where(mt & 4, word >> (code & 31) & 1,
                                         staged[None, :] < pay)))
        want = dec[ts, ss, :wf]
        bad = np.argwhere(got != want)
        if bad.size:
            i, c = bad[0]
            log.fatal(f"tree {ts[i]} node {ss[i]}: its compact record "
                      f"decides {got[i, c]} at code {c} of feature {f}, "
                      f"its decision row {want[i, c]}")


def _tree_depths(lefts: Sequence, rights: Sequence) -> np.ndarray:
    """[T] nodes on each tree's longest root-to-leaf path (0 for a
    single-leaf tree); fatal on malformed child pointers."""
    depth = np.zeros(len(lefts), np.int32)
    for t, (left, right) in enumerate(zip(lefts, rights)):
        if left.size:
            depth[t] = _tree_depth(t, left, right)
    return depth


def _tree_depth(t: int, left: np.ndarray, right: np.ndarray) -> int:
    """Nodes on the longest root-to-leaf path; fatal unless the child
    pointers form one tree over nodes [0, ns) and leaves [0, ns]."""
    ns = left.size
    seen = np.zeros(ns, bool)
    leaves = np.zeros(ns + 1, bool)
    best = 0
    stack = [(0, 1)]
    while stack:
        node, d = stack.pop()
        if node >= ns or seen[node]:
            log.fatal(f"tree {t}: malformed child pointers at node {node}")
        seen[node] = True
        best = max(best, d)
        for child in (int(left[node]), int(right[node])):
            if child >= 0:
                stack.append((child, d + 1))
            elif ~child > ns or leaves[~child]:
                log.fatal(f"tree {t}: malformed leaf pointer {child}")
            else:
                leaves[~child] = True
    if not seen.all():
        log.fatal(f"tree {t}: nodes unreachable from the root")
    return best


def edge_tensors(E_f32: np.ndarray, off32: np.ndarray, nan_slot: np.ndarray,
                 device):
    """The device-binning tables (f32 edges rounded down, per-feature
    code offsets, NaN slots) as device tensors for ``codes_from_x``."""
    return (torch.from_numpy(np.ascontiguousarray(E_f32)).to(device),
            torch.from_numpy(np.ascontiguousarray(off32)).to(device),
            torch.from_numpy(np.ascontiguousarray(nan_slot)).to(device))


def _feature_codes(x: np.ndarray, edges: Optional[np.ndarray],
                   cats: Optional[np.ndarray]) -> np.ndarray:
    """Values -> LOCAL bin codes for one feature under the table
    layout of _rebuild_tables.

    Numerical: [closed-right bins][overflow][NaN].
    Categorical: [known cats][other][negative/NaN]."""
    N = x.shape[0]
    if cats is not None:
        nan = np.isnan(x)
        neg = ~nan & (x < 0)
        cat = np.trunc(np.where(nan | neg, 0, x))
        if cats.size:
            pos = np.clip(np.searchsorted(cats, cat), 0, cats.size - 1)
            known = cats[pos] == cat
        else:
            # empty bitset (all categories go right): every value maps
            # to the "other" slot
            pos = np.zeros(N, np.int64)
            known = np.zeros(N, bool)
        b = np.where(known, pos, cats.size)          # other
        return np.where(nan | neg, cats.size + 1, b)  # neg/NaN slot
    edges = edges if edges is not None else np.zeros(0, np.float64)
    nan = np.isnan(x)
    b = np.searchsorted(edges, np.where(nan, 0.0, x), side="left")
    return np.where(nan, edges.size + 1, b)


def _node_table(tree, s: int, reps: np.ndarray) -> np.ndarray:
    """Evaluate node s's decision (go-left=1) at each representative
    value — vectorized mirror of tree.h:183-201 / Tree._decision."""
    dt = tree.decision_type[s]
    if dt & K_CATEGORICAL_MASK:
        nan = np.isnan(reps)
        ok = ~nan & (reps >= 0)
        cat = np.trunc(np.where(ok, reps, 0)).astype(np.int64)
        ci = tree.threshold_in_bin[s]
        lo, hi = tree.cat_boundaries[ci], tree.cat_boundaries[ci + 1]
        words = np.asarray(tree.cat_threshold[lo:hi], np.uint32)
        wi = cat // 32
        in_r = ok & (wi < (hi - lo))
        bit = np.zeros(reps.size, bool)
        if in_r.any():
            bit[in_r] = ((words[wi[in_r]]
                          >> (cat[in_r] % 32).astype(np.uint32)) & 1) != 0
        return bit.astype(np.int8)
    mt = (dt >> 2) & 3
    def_left = bool(dt & K_DEFAULT_LEFT_MASK)
    nan = np.isnan(reps)
    fz = np.where(nan & (mt != MissingType.NAN), 0.0, reps)
    miss = (((mt == MissingType.ZERO)
             & (fz >= -_ZERO_EPS) & (fz <= _ZERO_EPS))
            | ((mt == MissingType.NAN) & nan))
    with np.errstate(invalid="ignore"):
        go_left = np.where(miss, def_left, fz <= tree.threshold[s])
    return go_left.astype(np.int8)


def _f32_exact(X64: np.ndarray, X32: np.ndarray) -> bool:
    """True when every finite value round-trips f64 -> f32 -> f64."""
    with np.errstate(invalid="ignore"):
        same = (X32.astype(np.float64) == X64) | np.isnan(X64)
    return bool(same.all())
