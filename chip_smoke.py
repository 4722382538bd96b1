"""Smoke run of the PyTorch/CUDA port (lightgbm_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds every kernel from lightgbm_tpu_torch/csrc (one nvcc per source,
all at once), then drives the port's scoring and training paths through
the entry points a user calls:

1. device: needs CUDA; prints the card's name and power limit;
2. build: nvcc's time and register report for each source;
3. golden: every case of tests/data/golden2 through
   ``Booster(model_file=...).predict`` against the reference LightGBM's
   predictions (host binning, float64 X), and the same X as float32
   (device binning) against the port's float64 host walk;
4. full width: a HIGGS-shape model (500 trees x 255 leaves, 28
   features, random from a seed) scoring 500,000 rows; every row of
   both kernel launches against the plain PyTorch version on the same
   device codes (bit for bit), and a subset against the host walk;
5. serving: an LRB window model (50 trees x 31 leaves, 53 features)
   answering requests of 1, 7, 1000 and 65,536 rows through the C-API
   calls, each checked against the plain version;
6. LRB window training: the paper's TRAIN_PARAMS on 1,000,000 rows x 53
   features through the C-API sequence (DatasetCreateFromMat ->
   SetField -> BoosterCreate -> UpdateOneIter x50 -> GetEval ->
   SaveModelToString -> PredictForMat on the next 65,536 rows);
7. HIGGS-shape training: 11,000,000 rows x 28 features, max_bin 63, 255
   leaves, 10 iterations through ``lightgbm_tpu_torch.train``; phases 6
   and 7 both capture the inputs of their first root pass (K2), their
   first and widest fused pass (K1; in phase 6 under bagging) and their
   first score update (K3);
8. kernels vs plain at those captured shapes: K1 and K2 bit for bit
   against their plain version run on the CPU in the kernels' order of
   addition (every channel, and K1's leaf ids), two launches
   bit-identical, K3 bit for bit; the g and h sums against a float64
   plain run as a second reading; times of each kernel, its plain
   version and the nearest PyTorch library call;
9. card vs CPU: the LRB parameters at 100,000 rows trained on the card
   and with ``device="cpu"``. The card's tree at the first difference,
   grown again with K1 and K2 swapped for their kernel-order plain
   versions, equals its record bit for bit; the differing split is a
   near tie, within the f32 rounding of the two runs' own gains
   (``explain_difference``); train AUC within 4e-4.

Prints a JSON line of the kernels, then the last line
``{"ok": true, "device": {...}}``. Any failed check raises, and the
script exits non-zero without that line. The model generators are
importable (the body runs only under ``__main__``).
"""
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "data", "golden2")
GOLDEN_CASES = ["binary", "regl2", "regl1", "multic", "catbin",
                "dart", "goss", "contin", "rank", "wbin"]
REVERSE_ONLY = ["proxy", "pkd4"]

HOLDOUT_ROWS = 500_000          # bench.py's HIGGS holdout
HIGGS_TREES, HIGGS_LEAVES = 500, 255
LRB_TREES, LRB_LEAVES = 50, 31
HISTFEATURES = 50               # lightgbm_tpu/lrb.py: 50 gaps + 3 columns
LRB_FEATURES = HISTFEATURES + 3
SUBSET = 16_384
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12          # f32 outside the tensor cores

TRAIN_PARAMS = {                # lightgbm_tpu/lrb.py:64-81 (test.cpp:67-87)
    "boosting": "gbdt",
    "objective": "binary",
    "metric": "binary_logloss,auc",
    "metric_freq": "1",
    "is_provide_training_metric": "true",
    "max_bin": "255",
    "num_iterations": "50",
    "learning_rate": "0.1",
    "num_leaves": "31",
    "tree_learner": "serial",
    "feature_fraction": "0.8",
    "bagging_freq": "5",
    "bagging_fraction": "0.8",
    "min_data_in_leaf": "50",
    "min_sum_hessian_in_leaf": "5.0",
    "verbose": "-1",
}
LRB_TRAIN_ROWS = 1_000_000
LRB_NEXT_ROWS = 65_536
HIGGS_TRAIN_ROWS = 11_000_000   # bench.py BASELINE_ROWS
HIGGS_PARAMS = {"objective": "binary", "metric": "auc", "max_bin": 63,
                "num_leaves": 255, "learning_rate": 0.1,
                "min_data_in_leaf": 20, "verbose": -1}   # bench.py:877-881
HIGGS_ITERS = 10
CPU_ROWS = 100_000
AUC_TOL = 4e-4


def make_higgs_like(n_rows: int, n_features: int = 28, seed: int = 7):
    """Synthetic HIGGS-shaped task (bench.py): 28 continuous features,
    nonlinear decision boundary, balanced classes."""
    r = np.random.default_rng(seed)
    X = r.normal(size=(n_rows, n_features)).astype(np.float32)
    logit = (X[:, 0] * X[:, 1] + 0.5 * X[:, 2] - 0.3 * X[:, 3] * X[:, 4]
             + 0.2 * np.abs(X[:, 5]) + 0.1 * X[:, 6])
    y = (logit + 0.5 * r.normal(size=n_rows) > 0).astype(np.float32)
    return X, y


def make_lrb_rows(n_rows: int, seed: int = 3) -> np.ndarray:
    """LRB request features (lightgbm_tpu/lrb.py _derive_features):
    inter-arrival gaps (zero past an object's history), log2 size,
    log2 available bytes and cost, as float64 integers."""
    r = np.random.default_rng(seed)
    X = np.zeros((n_rows, LRB_FEATURES), np.float64)
    hist = r.integers(0, HISTFEATURES + 1, n_rows)
    gaps = r.integers(1, 50_000, size=(n_rows, HISTFEATURES))
    X[:, :HISTFEATURES] = np.where(
        np.arange(HISTFEATURES)[None, :] < hist[:, None], gaps, 0)
    X[:, HISTFEATURES] = np.round(100.0 * np.log2(
        r.integers(64, 1 << 24, n_rows)))
    X[:, HISTFEATURES + 1] = np.round(100.0 * np.log2(
        r.integers(1, 1 << 30, n_rows)))
    X[:, HISTFEATURES + 2] = 1.0
    return X


def lrb_labels(X: np.ndarray, seed: int) -> np.ndarray:
    """A seeded label rule on LRB rows: requested again soon when the
    last gap is short, flipped by log2 size, with 5% noise."""
    r = np.random.default_rng(seed)
    soon = (X[:, 0] > 0) & (X[:, 0] < 15_000)
    y = soon ^ (X[:, HISTFEATURES] < 2200)
    return (y ^ (r.random(X.shape[0]) < 0.05)).astype(np.float32)


def random_model_text(X: np.ndarray, n_trees: int, n_leaves: int,
                      seed: int, objective: str = "binary sigmoid:1") -> str:
    """LightGBM v2 model text of ``n_trees`` random trees: each grows by
    splitting a random leaf until it has ``n_leaves``, on a random
    feature at a threshold from that column's 255-quantile grid, with
    missing types and default directions mixed; leaf values ~ N(0,
    0.05)."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.models.gbdt import GBDT
    from lightgbm_tpu_torch.models.tree import Tree
    from lightgbm_tpu_torch.objectives import (
        parse_objective_from_model_string)
    r = np.random.default_rng(seed)
    F = X.shape[1]
    grid = [np.unique(np.quantile(X[:, f].astype(np.float64),
                                  np.linspace(0, 1, 257)[1:-1]))
            for f in range(F)]
    g = GBDT()
    g.max_feature_idx = F - 1
    g.feature_names = [f"Column_{f}" for f in range(F)]
    g.feature_infos = ["none"] * F
    g.objective = parse_objective_from_model_string(objective, Config())
    g.num_class = g.num_tree_per_iteration = getattr(
        g.objective, "num_class", 1)
    for _ in range(n_trees):
        t = Tree(n_leaves)
        while t.num_leaves < n_leaves:
            f = int(r.integers(F))
            t.split(leaf=int(r.integers(t.num_leaves)), feature=f,
                    threshold_bin=0,
                    threshold_real=float(r.choice(grid[f])),
                    left_value=0.0, right_value=0.0, left_count=0,
                    right_count=0, gain=1.0,
                    missing_type=int(r.integers(3)),
                    default_left=bool(r.integers(2)))
        t.leaf_value = list(r.normal(0.0, 0.05, t.num_leaves))
        g.models.append(t)
    return g.model_to_string()


def host_raw(gbdt, X: np.ndarray) -> np.ndarray:
    """The port's float64 host walk: raw scores [K, N]."""
    k = gbdt.num_tree_per_iteration
    out = np.zeros((k, X.shape[0]))
    for t, tree in enumerate(gbdt.models):
        out[t % k] += tree.predict(X)
    if gbdt.average_output:
        out /= max(len(gbdt.models) // k, 1)
    return out


def cuda_ms(fn, runs: int, warmup: int = 1) -> float:
    """Median milliseconds of ``fn`` over ``runs`` CUDA-event timings."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def leaf_depths(gbdt, n_leaves: int) -> np.ndarray:
    """[T, n_leaves] nodes on the path from each tree's root to each of
    its leaves (0 for a single-leaf tree)."""
    out = np.zeros((len(gbdt.models), n_leaves), np.int64)
    for t, tree in enumerate(gbdt.models):
        stack = [(0, 1)] if tree.num_leaves > 1 else []
        while stack:
            node, d = stack.pop()
            for child in (tree.left_child[node], tree.right_child[node]):
                if child < 0:
                    out[t, ~child] = d
                else:
                    stack.append((child, d + 1))
    return out


def measure_kernel(gbdt, X32: np.ndarray, dev) -> dict:
    """The forest kernel's median time on ``X32``'s device-binned codes,
    its plain version's, and its bound: the larger of the bytes it must
    move (codes and tables read once, scores written once) over HBM
    bandwidth and its operations (one per node visit this data makes,
    counted from the leaves it reaches, plus one f32 add per row-tree)
    over the f32 rate."""
    import torch
    from lightgbm_tpu_torch.ops import forest as forest_ops
    from lightgbm_tpu_torch.ops import stacked_predict as sp
    sm = gbdt._stacked_model()
    fc = sm.forest
    T = fc.leaf.shape[0]
    n = X32.shape[0]
    codes = sp.codes_from_x(torch.from_numpy(X32).to(dev), *sm.edges)
    ms = cuda_ms(lambda: forest_ops.forest_predict(codes, fc, 0, T), 10)
    plain_ms = cuda_ms(
        lambda: forest_ops.forest_predict_plain(codes, fc, 0, T), 3)
    leaves = forest_ops.forest_predict(codes, fc, 0, T, leaf_mode=True)
    depth = torch.from_numpy(leaf_depths(gbdt, fc.leaf.shape[1])).to(dev)
    visits = int(depth[torch.arange(T, device=dev)[None, :],
                       leaves.long()].sum())
    F, S, Wn, L = (fc.num_features, fc.dec.shape[1], fc.dec.shape[2],
                   fc.leaf.shape[1])
    K = fc.num_class
    nbytes = (4 * F * n + 4 * K * n + 16 * T * S + T * S * Wn + 4 * T * L
              + 4 * T)
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = (visits + n * T) / H100_F32_FLOPS * 1e3
    return {"rows": n, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "visits": visits, "bytes": nbytes}


def wall_ms(fn, runs: int) -> list:
    """Host-clock milliseconds of each of ``runs`` calls of ``fn``, each
    ending in a synchronize."""
    import torch
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def device_busy(fn, runs: int):
    """(wall ms, device-busy ms) of one window of ``runs`` calls of
    ``fn``: the host clock around the window, and the time the card
    spent in kernels and copies in it, from torch.profiler's CUDA
    activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return wall, busy


def host_prep_ms(X: np.ndarray) -> float:
    """Host time of predict's first step at this input: the float64 view
    and the f32-exactness check that picks device binning."""
    from lightgbm_tpu_torch.ops import stacked_predict as sp
    t0 = time.perf_counter()
    X64 = np.ascontiguousarray(np.asarray(X, np.float64))
    assert sp._f32_exact(X64, X64.astype(np.float32))
    return (time.perf_counter() - t0) * 1e3


class Capture:
    """Calls ``fn`` and keeps clones of the tensor arguments of its first
    call, or with ``key``, of the first call with the largest
    ``key(args)`` (cloned before the call: K3 updates its scores in
    place)."""

    def __init__(self, fn, key=None):
        self.fn = fn
        self.key = key
        self.args = None
        self.best = None

    def __call__(self, *args):
        import torch
        k = None if self.key is None else self.key(args)
        if self.args is None or (k is not None and k > self.best):
            self.args = tuple(a.clone() if torch.is_tensor(a) else a
                              for a in args)
            self.best = k
        return self.fn(*args)


@contextlib.contextmanager
def capturing():
    """While active, the grower's K1 and K2 calls and the boosting loop's
    K3 call go through Captures: K2's first call (the first root pass),
    K1's first and its widest, K3's first. Yields them by name."""
    from lightgbm_tpu_torch.models import gbdt as gbdt_mod
    from lightgbm_tpu_torch.ops import wave_grower as wg
    k1 = Capture(wg.fused_partition_histogram)
    caps = {"K1": k1, "K2": Capture(wg.wave_histogram),
            "K3": Capture(gbdt_mod.add_leaf_outputs),
            "K1w": Capture(k1, key=lambda a: a[5].shape[1])}
    wg.fused_partition_histogram = caps["K1w"]
    wg.wave_histogram = caps["K2"]
    gbdt_mod.add_leaf_outputs = caps["K3"]
    try:
        yield caps
    finally:
        wg.fused_partition_histogram = k1.fn
        wg.wave_histogram = caps["K2"].fn
        gbdt_mod.add_leaf_outputs = caps["K3"].fn


def bound(nbytes: float, ops: float) -> dict:
    """The least time for a function: bytes over HBM bandwidth or f32
    operations over the f32 rate, whichever is larger."""
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_F32_FLOPS * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": int(nbytes), "ops": int(ops)}


def f32_sum_bound(counts, abs_sums):
    """Worst-case error of any order of f32 additions of a cell's
    values: (count - 1) * 2**-24 * sum |v| (the gamma_{n-1} bound),
    with 1% headroom for its second-order term."""
    return (counts - 1).clamp(min=0) * 2.0 ** -24 * abs_sums * 1.01


@contextlib.contextmanager
def kernel_order():
    """While active, the plain histogram versions add in the kernels'
    order: each cell in row order within a row range (``row_ranges``,
    the kernels' ranges), then the ranges' partial sums in range order.
    ``index_add_`` on the CPU adds in index order, so on CPU tensors this
    is the kernels' sum bit for bit."""
    from lightgbm_tpu_torch.ops import hist_wave as hw
    row_order = hw._scatter_hist3
    if getattr(row_order, "kernel_order", False):
        yield
        return

    def range_order(bins_t, g, h, base, num_bins, num_slots):
        F, n = bins_t.shape
        R, per = hw.row_ranges(n, F)
        out = None
        for r in range(R):
            rows = slice(r * per, min(n, (r + 1) * per))
            part = row_order(bins_t[:, rows], g[rows], h[rows], base[rows],
                             num_bins, num_slots)
            out = part if out is None else out + part
        return out
    range_order.kernel_order = True
    hw._scatter_hist3 = range_order
    try:
        yield
    finally:
        hw._scatter_hist3 = row_order


def plain_in_kernel_order(plain, args):
    """``plain(*args)`` on CPU copies of ``args``, in the kernels' order
    of addition; the outputs go back to the first argument's device."""
    import torch
    dev = args[0].device
    with kernel_order():
        out = plain(*[a.cpu() if torch.is_tensor(a) else a for a in args])
    if isinstance(out, tuple):
        return tuple(o.to(dev) for o in out)
    return out.to(dev)


def check_histogram(name, kernel, plain, args, hist_of, slots_of):
    """One histogram kernel (K1 or K2) on captured main-path inputs
    ``args`` (bins_t, g, h, ...): two launches bit-identical, and every
    channel (and K1's leaf ids) bit for bit equal to the plain version
    run on the CPU in the kernels' order of addition. A second reading,
    printed: the g and h sums against the plain version in float64, as a
    share of the f32 summation bound. Returns the stats."""
    import torch
    out1 = kernel(*args)
    out2 = kernel(*args)
    torch.cuda.synchronize()
    h1 = hist_of(out1)
    assert torch.equal(h1, hist_of(out2)), f"{name}: two launches differ"
    want = plain_in_kernel_order(plain, args)
    assert torch.equal(h1, hist_of(want)), \
        f"{name}: sums differ from the plain version in the kernels' order"
    if slots_of is not None:
        assert torch.equal(slots_of(out1), slots_of(out2)), \
            f"{name}: leaf ids differ between launches"
        assert torch.equal(slots_of(out1), slots_of(want)), \
            f"{name}: leaf ids differ from the plain version"
    bins_t, g, h = args[0], args[1], args[2]
    h64 = hist_of(plain(bins_t, g.double(), h.double(), *args[3:]))
    habs = hist_of(plain(bins_t, g.double().abs(), h.double().abs(),
                         *args[3:]))
    err = (h1[..., :2].double() - h64[..., :2]).abs()
    tol = f32_sum_bound(h64[..., 2:3], habs[..., :2])
    return {"max_abs_err": float((h1 - hist_of(want)).abs().max()),
            "max_abs_err_f64": float(err.max()),
            "max_bound_used": float((err / tol.clamp(min=1e-300)).max()),
            "rows_counted": int(h64[:, 0, :, 2].sum())}


def lib_index_add(args, dev):
    """The K2 yardstick: one ``index_add_`` of the three channels on a
    flat index built beforehand (the plain version's scatter)."""
    import torch
    bins_t, g, h, leaf, wl, B = args
    F, n = bins_t.shape
    W = wl.shape[0]
    eq = (leaf[None, :] == wl[:, None]) & (wl >= 0)[:, None]
    base = torch.where(eq.any(0), torch.argmax(eq.to(torch.uint8), 0)
                       * (F * B), W * F * B)
    flat = (base[None, :] + torch.arange(F, device=dev)[:, None] * B
            + bins_t.long()).reshape(-1)
    vals = torch.stack([g.expand(F, n), h.expand(F, n),
                        torch.ones(F, n, device=dev)], -1).reshape(-1, 3)
    out = torch.zeros(((W + 1) * F * B, 3), device=dev)

    def call():
        out.index_add_(0, flat, vals)
    return cuda_ms(call, 5)


def split_keys(tree) -> list:
    """(parent leaf, feature, threshold, decision type) of each split in
    split order. Split i's parent leaf is the leaf its left child keeps:
    the end of the left-child chain below node i."""
    keys = []
    for i in range(tree.num_leaves - 1):
        node = tree.left_child[i]
        while node >= 0:
            node = tree.left_child[node]
        keys.append((~node, tree.split_feature[i], tree.threshold[i],
                     tree.decision_type[i]))
    return keys


def tree_diff(a_models, b_models):
    """The first split where two lists of trees differ: None, or (tree,
    split, its gain in a, its gain in b); split -1 when every split
    agrees but a leaf or node count does not."""
    for t, (ta, tb) in enumerate(zip(a_models, b_models)):
        ka, kb = split_keys(ta), split_keys(tb)
        for i in range(max(len(ka), len(kb))):
            if i >= len(ka) or i >= len(kb) or ka[i] != kb[i]:
                ga = ta.split_gain[i] if i < len(ka) else 0.0
                gb = tb.split_gain[i] if i < len(kb) else 0.0
                return t, i, ga, gb
        if (ta.leaf_count != tb.leaf_count
                or ta.internal_count != tb.internal_count):
            return t, -1, 0.0, 0.0
    return None


def auc_np(y: np.ndarray, p: np.ndarray) -> float:
    """AUC with tied scores at their average rank."""
    order = np.argsort(p, kind="mergesort")
    ps, ys = p[order], y[order] > 0
    _, inv, cnt = np.unique(ps, return_inverse=True, return_counts=True)
    ends = np.cumsum(cnt)
    ranks = (ends - (cnt - 1) / 2.0)[inv]
    npos = ys.sum()
    nneg = len(ys) - npos
    return float((ranks[ys].sum() - npos * (npos + 1) / 2) / (npos * nneg))


def card_tree_in_kernel_order(booster, inputs, t: int) -> dict:
    """Tree ``t`` of a booster trained on the card, grown again on the
    card from the same grower inputs, with K1 and K2 swapped for their
    plain versions run on the CPU in the kernels' order: everything else,
    the split search included, runs as in training. Returns the record
    with the shrinkage folded as ``train_one_iter`` folds it (t >= 1: no
    bias). Equal records mean that every K1 and K2 launch of that tree
    matched its plain version bit for bit."""
    from lightgbm_tpu_torch.ops import hist_wave as hw
    from lightgbm_tpu_torch.ops import wave_grower as wg
    gb = booster._gbdt
    dev = gb.train_data.bins_t.device
    saved = wg.wave_histogram, wg.fused_partition_histogram
    wg.wave_histogram = lambda *a: plain_in_kernel_order(
        hw.wave_histogram_plain, a)
    wg.fused_partition_histogram = lambda *a: plain_in_kernel_order(
        hw.fused_partition_histogram_plain, a)
    try:
        rec, _ = wg.WaveGrower.grow(gb._grower, gb.train_data.bins_t,
                                    *[x.to(dev) for x in inputs[t]])
    finally:
        wg.wave_histogram, wg.fused_partition_histogram = saved
    shrink = float(np.float32(gb.shrinkage_rate))
    bias = float(np.float32(0.0))
    return rec._replace(
        leaf_output=rec.leaf_output * shrink + bias,
        internal_value=rec.internal_value * shrink + bias).to_numpy()


def explain_difference(runs: dict, t: int, i: int) -> dict:
    """Both runs' split number ``i`` of tree ``t`` (their first
    difference), each evaluated in float64 on each run's own grower
    inputs of that tree: the candidate's gain (l1 = 0), its two sides'
    hessian sums and counts. The trees agree on splits 0..i-1, so both
    candidates see the same leaf membership.

    The verdict is a near tie when the candidates' float64 gains differ
    by less than the f32 rounding that the two runs' own gains carry:
    each run's recorded f32 gain of its choice against that choice's
    float64 gain on its inputs, added over the two runs. A leaf's f32
    histogram comes from its ancestors' by subtraction and carries their
    rounding, and two orders of addition can rank candidates that close
    either way. It is a hessian-boundary tie when a side's hessian sum
    lies within 1e-5 of min_sum_hessian_in_leaf, where f32 rounding
    decides validity."""
    import torch
    from lightgbm_tpu_torch.ops.partition import row_goes_right
    from lightgbm_tpu_torch.ops.predict import replay_partition
    gb = runs["cpu"][0]._gbdt
    cfg, meta = gb.config, gb._grower.meta
    bins = gb.train_data.bins_t
    recs = {w: runs[w][0]._gbdt.records[t].to_numpy() for w in runs}
    cand = {w: tuple(int(r[k][i]) for k in ("split_leaf", "split_feature",
                                             "split_bin",
                                             "split_default_left"))
            for w, r in recs.items()}
    leaf = replay_partition(gb.records[t]._replace(num_leaves=i + 1), bins,
                            meta)
    l2 = cfg.lambda_l2
    table = {}
    for src in runs:
        g, h, mask = [a.double() for a in runs[src][3][t][:3]]
        g, h = g * mask, h * mask
        for w, (lf, f, b, dl) in cand.items():
            rows = (leaf == lf) & (mask > 0)
            right = row_goes_right(bins[f].to(torch.int32), b, bool(dl),
                                   int(meta.missing_type[f]),
                                   int(meta.default_bin[f]),
                                   int(meta.num_bin[f]))
            side = {}
            for name, m in (("left", rows & ~right), ("right", rows & right)):
                side[name] = (float(g[m].sum()), float(h[m].sum()),
                              int(m.sum()))
            gl, hl, nl = side["left"]
            gr, hr, nr = side["right"]
            gain = (gl * gl / (hl + l2) + gr * gr / (hr + l2)
                    - (gl + gr) ** 2 / (hl + hr + l2))
            table[(src, w)] = {"leaf": lf, "feature": f, "bin": b,
                               "gain": gain, "hess": (hl, hr),
                               "count": (nl, nr)}
    rounding = sum(abs(float(recs[w]["split_gain"][i]) - table[(w, w)]["gain"])
                   for w in runs)
    gap = max(abs(table[(src, "cuda")]["gain"] - table[(src, "cpu")]["gain"])
              for src in runs)
    msh = cfg.min_sum_hessian_in_leaf
    boundary = any(abs(hs - msh) <= 1e-5 * msh
                   for v in table.values() for hs in v["hess"])
    return {"table": table, "gap": gap, "rounding": rounding,
            "gain_tie": gap <= rounding, "hessian_boundary": boundary}


def check_kernels(caps, label: str, dev) -> dict:
    """K2, K1 and K3 against their plain versions on one training's
    captured inputs (check_histogram; K3 bit for bit), with each
    kernel's time, its plain version's, the library call's and the
    bound at those shapes. K2 is the first root pass, K1 the first and
    the widest wave (the widest is timed), K3 the first score update."""
    import torch
    from lightgbm_tpu_torch.ops import hist_wave as hw
    from lightgbm_tpu_torch.ops import predict as pr
    a2, a1 = caps["K2"].args, caps["K1w"].args
    bins_t, B = a2[0], a2[-1]
    F, n = bins_t.shape
    out = {}
    st2 = check_histogram("K2", hw.wave_histogram, hw.wave_histogram_plain,
                          a2, lambda o: o, None)
    W2 = a2[4].shape[0]
    out["K2"] = dict(
        st2, shape=f"F={F}, N={n}, W={W2}, B={B}",
        ms=cuda_ms(lambda: hw.wave_histogram(*a2), 5),
        plain_ms=cuda_ms(lambda: hw.wave_histogram_plain(*a2), 3),
        library_ms=lib_index_add(a2, dev),
        **bound(F * n + 12 * n + 4 * W2 + 12 * W2 * F * B,
                3 * F * st2["rows_counted"]))
    first = check_histogram(
        "K1", hw.fused_partition_histogram,
        hw.fused_partition_histogram_plain, caps["K1"].args,
        lambda o: o[1], lambda o: o[0])
    st1 = check_histogram(
        "K1", hw.fused_partition_histogram,
        hw.fused_partition_histogram_plain, a1, lambda o: o[1],
        lambda o: o[0])
    W1 = a1[5].shape[1]
    out["K1"] = dict(
        st1, shape=f"F={F}, N={n}, W={W1}, B={B}",
        first_wave={"W": caps["K1"].args[5].shape[1],
                    "max_abs_err_f64": first["max_abs_err_f64"]},
        in_bag_rows=int((a1[3] > 0).sum()),
        ms=cuda_ms(lambda: hw.fused_partition_histogram(*a1), 5),
        plain_ms=cuda_ms(lambda: hw.fused_partition_histogram_plain(*a1), 3),
        library_ms=None,
        **bound(F * n + 20 * n + 36 * W1 + 12 * W1 * F * B,
                n + 3 * F * st1["rows_counted"]))
    sc, leaf, table = caps["K3"].args
    got = pr.add_leaf_outputs(sc.clone(), leaf, table)
    want = pr.add_leaf_outputs_plain(sc.clone(), leaf, table)
    assert torch.equal(got, want), "K3 != plain"
    s1, s2 = sc.clone(), sc.clone()
    out["K3"] = dict(
        max_abs_err=0.0, shape=f"N={n}, L={table.shape[0]}",
        ms=cuda_ms(lambda: pr.add_leaf_outputs(s1, leaf, table), 20),
        plain_ms=cuda_ms(
            lambda: pr.add_leaf_outputs_plain(s2, leaf, table), 20),
        library_ms=None, **bound(12 * n + 4 * table.shape[0], n))
    for name in ("K2", "K1"):
        k = out[name]
        lib = k["library_ms"]
        print(f"{label} {name} at [{k['shape']}]: {k['ms']:.3f} ms, plain "
              f"{k['plain_ms']:.3f} ms, library "
              f"{'none' if lib is None else f'{lib:.3f} ms'}, bound "
              f"{k['bound_ms']:.4f} ms ({k['bound_by']}); bit-equal to the "
              f"plain version in the kernels' order (sums, counts"
              f"{', leaf ids' if name == 'K1' else ''}); g/h within "
              f"{k['max_abs_err_f64']:.3g} of float64 "
              f"({k['max_bound_used']:.4f} of the f32 bound); two launches "
              f"bit-identical")
    print(f"{label} K1, first wave (W={out['K1']['first_wave']['W']}): "
          f"bit-equal too, g/h within {first['max_abs_err_f64']:.3g} of "
          f"float64; widest wave {out['K1']['in_bag_rows']} of {n} rows in "
          f"bag")
    k = out["K3"]
    print(f"{label} K3 at [{k['shape']}]: {k['ms']:.4f} ms, plain "
          f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
          f"({k['bound_by']}); bit-equal to plain")
    return out


def train_phases(dev) -> list:
    """Phases 6-9 of the module docstring. Returns the kernels-line
    entries of K2, K1 and K3."""
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import capi
    from lightgbm_tpu_torch.ops import forest as forest_ops
    from lightgbm_tpu_torch.ops import hist_wave as hw
    from lightgbm_tpu_torch.ops import predict as pr
    counters = {"K2": hw.k2_launches, "K1": hw.k1_launches,
                "K3": pr.launches, "K4": forest_ops.launches}

    def reset():
        torch.cuda.synchronize()
        for c in counters.values():
            c.reset()

    def read():
        torch.cuda.synchronize()
        return {k: c.value for k, c in counters.items()}

    # 6. LRB window training through the C-API sequence, capturing kernel
    # inputs (bagging is on from the first iteration)
    X = make_lrb_rows(LRB_TRAIN_ROWS, seed=21)
    y = lrb_labels(X, seed=22)
    Xn = make_lrb_rows(LRB_NEXT_ROWS, seed=23)
    yn = lrb_labels(Xn, seed=24)
    with capturing() as lrb_caps:
        reset()
        t0 = time.perf_counter()
        ds = capi.LGBM_DatasetCreateFromMat(X, parameters=TRAIN_PARAMS)
        capi.LGBM_DatasetSetField(ds, "label", y)
        bst = capi.LGBM_BoosterCreate(ds, TRAIN_PARAMS)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        iters = []
        for _ in range(int(TRAIN_PARAMS["num_iterations"])):
            t1 = time.perf_counter()
            finished = capi.LGBM_BoosterUpdateOneIter(bst)
            torch.cuda.synchronize()
            iters.append(time.perf_counter() - t1)
            if finished:
                break
        evals = dict(capi.LGBM_BoosterGetEval(bst, 0))
        text = capi.LGBM_BoosterSaveModelToString(bst)
        pred = np.asarray(capi.LGBM_BoosterPredictForMat(bst, Xn))
        lrb_counts = read()
    assert all(v > 0 for v in lrb_counts.values()), lrb_counts
    assert bool((lrb_caps["K1"].args[3] == 0).any()), "no out-of-bag rows"
    assert pred.shape == (LRB_NEXT_ROWS,) and np.isfinite(pred).all()
    assert evals["auc"] > 0.6, evals
    host = host_raw(lgt.Booster(model_str=text, device="cpu")._gbdt,
                    Xn[:SUBSET])[0]
    err_host = float(np.abs(pred[:SUBSET] - 1 / (1 + np.exp(-host))).max())
    assert err_host <= 1e-5, f"lrb model text: {err_host} from host walk"
    n_it = len(iters)
    lrb_ms = 1e3 * float(np.median(iters))
    print(f"lrb training: {LRB_TRAIN_ROWS} x {LRB_FEATURES}, {n_it} "
          f"iterations; binning and setup {setup_s:.2f} s; median "
          f"{lrb_ms:.1f} ms/iteration, "
          f"{LRB_TRAIN_ROWS * n_it / sum(iters):.0f} row-iterations/s; "
          f"train auc {evals['auc']:.5f}, binary_logloss "
          f"{evals['binary_logloss']:.5f}; next window auc "
          f"{auc_np(yn, pred):.5f}; model text scores within "
          f"{err_host:.2g} of the host walk; launches {lrb_counts}")
    wall, busy = device_busy(lambda: capi.LGBM_BoosterUpdateOneIter(bst), 3)
    print(f"lrb profile, one window of 3 iterations: wall {wall:.1f} ms, "
          f"device busy {busy:.2f} ms ({100 * busy / wall:.1f}%)")
    capi.LGBM_BoosterFree(bst)
    del X, ds, bst

    # 7. HIGGS-shape training through train(), capturing kernel inputs
    X, y = make_higgs_like(HIGGS_TRAIN_ROWS)
    Xt, yt = make_higgs_like(HOLDOUT_ROWS, seed=8)
    with capturing() as higgs_caps:
        reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ds = lgt.Dataset(X, label=y, params=HIGGS_PARAMS).construct()
        torch.cuda.synchronize()
        bin_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        bst = lgt.train(HIGGS_PARAMS, ds, num_boost_round=HIGGS_ITERS)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        higgs_counts = read()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for k in ("K1", "K2", "K3"):
        assert higgs_counts[k] > 0, higgs_counts
    prob = bst.predict(Xt)
    assert prob.shape == (HOLDOUT_ROWS,) and np.isfinite(prob).all()
    auc_t = auc_np(yt, prob)
    assert auc_t > 0.7, auc_t
    host = host_raw(bst._gbdt, Xt[:SUBSET].astype(np.float64))[0]
    err_host = float(np.abs(prob[:SUBSET] - 1 / (1 + np.exp(-host))).max())
    assert err_host <= 1e-5, f"higgs: {err_host} from the host walk"
    leaves = [t.num_leaves for t in bst._gbdt.models]
    print(f"higgs training: {HIGGS_TRAIN_ROWS} x 28, {HIGGS_ITERS} "
          f"iterations of {leaves} leaves; binning {bin_s:.2f} s; train "
          f"{train_s:.2f} s = {1e3 * train_s / HIGGS_ITERS:.1f} "
          f"ms/iteration, {HIGGS_TRAIN_ROWS * HIGGS_ITERS / train_s:.0f} "
          f"row-iterations/s; holdout auc {auc_t:.5f}; peak device memory "
          f"{peak_gb:.2f} GB; launches {higgs_counts}")
    wall, busy = device_busy(bst.update, 2)
    print(f"higgs profile, one window of 2 iterations: wall {wall:.1f} ms, "
          f"device busy {busy:.2f} ms ({100 * busy / wall:.1f}%)")
    del bst, ds, X

    # 8. each kernel against its plain version at the captured shapes
    t0 = time.perf_counter()
    lrb = check_kernels(lrb_caps, "lrb", dev)
    higgs = check_kernels(higgs_caps, "higgs", dev)
    del lrb_caps, higgs_caps
    print(f"kernel checks: {time.perf_counter() - t0:.1f} s")

    # 9. card vs CPU on the LRB parameters at 100,000 rows: the same
    # Booster.update loop train() runs, with each tree's grower inputs
    # kept to attribute the first difference
    X = make_lrb_rows(CPU_ROWS, seed=31)
    y = lrb_labels(X, seed=32)
    runs = {}
    for where in ("cuda", "cpu"):
        t0 = time.perf_counter()
        b = lgt.Booster(TRAIN_PARAMS, lgt.Dataset(X, label=y),
                        device=None if where == "cuda" else "cpu")
        grower = b._gbdt._grower
        inputs = []

        def grow(*args, _grow=grower.grow, _inputs=inputs):
            _inputs.append([a.cpu() for a in args[1:]])
            return _grow(*args)
        grower.grow = grow
        for _ in range(int(TRAIN_PARAMS["num_iterations"])):
            b.update()
        b.model_to_string()
        runs[where] = (b, dict((m, v) for _, m, v, _ in b.eval_train()),
                       time.perf_counter() - t0, inputs)
    gm, cm = runs["cuda"][0]._gbdt.models, runs["cpu"][0]._gbdt.models
    assert len(gm) == len(cm), (len(gm), len(cm))
    diff = tree_diff(gm, cm)
    d_auc = abs(runs["cuda"][1]["auc"] - runs["cpu"][1]["auc"])
    # the card's tree at the first difference (else its last), grown
    # again with the histograms in the kernels' order: bit for bit
    t = len(gm) - 1 if diff is None else diff[0]
    assert t >= 1, f"card and CPU differ in the first tree: {diff}"
    emu = card_tree_in_kernel_order(runs["cuda"][0], runs["cuda"][3], t)
    card = runs["cuda"][0]._gbdt.records[t].to_numpy()
    for k in card:
        assert np.array_equal(emu[k], card[k]), \
            f"card tree {t}: {k} differs from the kernel-order plain grower"
    print(f"  card tree {t} grown again with K1/K2 as their plain versions "
          f"in the kernels' order: the record is equal bit for bit")
    if diff is None:
        where = f"all {len(gm)} trees equal in structure and counts"
    else:
        t, i, ga, gc = diff
        why = explain_difference(runs, t, i)
        for (src, w), v in why["table"].items():
            print(f"  tree {t} split {i} chosen on the {w}: leaf {v['leaf']}"
                  f", feature {v['feature']} <= bin {v['bin']}; on the "
                  f"{src} run's gradients: gain {v['gain']:.9g}, hessian "
                  f"sums {v['hess'][0]:.9g} | {v['hess'][1]:.9g}, rows "
                  f"{v['count'][0]} | {v['count'][1]}")
        print(f"  float64 gain gap {why['gap']:.6g}; the f32 rounding of "
              f"the two runs' own gains {why['rounding']:.6g}")
        assert why["gain_tie"] or why["hessian_boundary"], \
            f"card and CPU trees differ at tree {t} split {i}, not a tie"
        kind = ("a near tie in gain" if why["gain_tie"] else
                "a hessian sum at min_sum_hessian_in_leaf")
        where = (f"trees equal up to tree {t}, split {i}, {kind} (split "
                 f"gains {ga:.7g} on the card, {gc:.7g} on the CPU)")
    assert d_auc <= AUC_TOL, f"card vs CPU auc differs by {d_auc}"
    print(f"card vs CPU, {CPU_ROWS} LRB rows x {len(gm)} iterations: {where};"
          f" train auc {runs['cuda'][1]['auc']:.6f} vs "
          f"{runs['cpu'][1]['auc']:.6f} (|diff| {d_auc:.2g} <= {AUC_TOL}); "
          f"{runs['cuda'][2]:.1f} s on the card, {runs['cpu'][2]:.1f} s on "
          f"the CPU")

    out = []
    src = "lightgbm_tpu_torch/csrc/"
    notes = {"K2": ("index_add_ of the three channels on a flat index "
                    "built beforehand"),
             "K1": ("no single PyTorch call partitions rows and builds "
                    "their histograms"),
             "K3": "no single PyTorch call gathers and adds"}
    keep = ("shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err", "max_abs_err_f64")
    for name, kid, path, rep in (
            ("wave_histogram", "K2", "hist_wave.cu",
             "lightgbm_tpu/ops/hist_wave.py:482"),
            ("fused_partition_histogram", "K1", "hist_wave.cu",
             "lightgbm_tpu/ops/hist_wave.py:984"),
            ("leaf_gather_add", "K3", "leaf_gather.cu",
             "lightgbm_tpu/ops/predict.py:64")):
        k = higgs[kid]
        out.append({
            "name": name, "route": "cuda", "source": src + path,
            "replaces": rep,
            "launches": lrb_counts[kid] + higgs_counts[kid],
            "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"], "library_note": notes[kid],
            "shape": k["shape"],
            "launches_per_iteration": {"lrb": lrb_counts[kid] / n_it,
                                       "higgs": higgs_counts[kid]
                                       / HIGGS_ITERS},
            "vs_plain": ("bitwise" if kid == "K3" else
                         "bitwise against the plain version run in the "
                         "kernels' order of addition"),
            "lrb": {f: lrb[kid][f] for f in keep if f in lrb[kid]},
            **({} if kid == "K3" else
               {"max_abs_err_f64": k["max_abs_err_f64"]})})
    return out


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    if not os.path.isdir(os.path.join(ROOT, "lightgbm_tpu_torch")):
        print("chip_smoke: lightgbm_tpu_torch is not beside this script",
              file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, ROOT)
    from lightgbm_tpu_torch import Booster, capi
    from lightgbm_tpu_torch.ops import forest as forest_ops
    from lightgbm_tpu_torch.ops import stacked_predict as sp
    from lightgbm_tpu_torch.utils import cuda_build

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")

    # 2. build: every csrc/*.cu, one nvcc each, all at once
    t0 = time.perf_counter()
    built = cuda_build.build_all()
    print(f"build: {len(built)} sources in {time.perf_counter() - t0:.2f} s")
    for name, b in built.items():
        print(f"  {name}: nvcc {b.seconds:.2f} s -> "
              f"{os.path.relpath(b.path, ROOT)}")
        for line in b.report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    ptxas: {line.strip()}")

    # 3. golden corpus: host binning, then device binning
    worst = 0.0
    for name in GOLDEN_CASES + REVERSE_ONLY:
        src = "proxy" if name in REVERSE_ONLY else name
        X = np.fromfile(os.path.join(GOLDEN, f"g2_{src}_X.bin"),
                        np.float64).reshape(600, 8)
        pairs = [(f"g2_{name}_ours_model.txt",
                  f"g2_{name}_ours_refpred.bin")]
        if name in GOLDEN_CASES:
            pairs.append((f"g2_{name}_model.txt", f"g2_{name}_pred.bin"))
        for model, pred in pairs:
            bst = Booster(model_file=os.path.join(GOLDEN, model))
            ref = np.fromfile(os.path.join(GOLDEN, pred), np.float64)
            got = np.asarray(bst.predict(X)).reshape(-1)
            err = float(np.abs(got - ref).max())
            worst = max(worst, err)
            assert err <= 1e-5, f"{model}: {err} from the reference"
            sm = bst._gbdt._stacked_model()
            assert sm is not None, f"{model}: not stacked"
            if sm.edges is None:
                continue
            X32 = X.astype(np.float32)
            codes = sp.codes_from_x(torch.from_numpy(X32).to(dev),
                                    *sm.edges).cpu().numpy()
            want = sm._bin_rows(X32.astype(np.float64)).T
            assert np.array_equal(codes, want), f"{model}: device codes"
            raw = np.asarray(bst.predict(X32, raw_score=True))
            host = host_raw(bst._gbdt, X32.astype(np.float64))
            err32 = float(np.abs(raw.reshape(-1)
                                 - (host[0] if host.shape[0] == 1
                                    else host.T).reshape(-1)).max())
            assert err32 <= 1e-5, f"{model} f32: {err32} from host walk"
    torch.cuda.synchronize()
    print(f"golden: {len(GOLDEN_CASES) * 2 + len(REVERSE_ONLY)} models "
          f"within 1e-5 of the reference (worst {worst:.3g})")

    # 4. full width: HIGGS-shape model, 500k rows
    X, _ = make_higgs_like(HOLDOUT_ROWS)
    text = random_model_text(X[:100_000], HIGGS_TREES, HIGGS_LEAVES, 11)
    t0 = time.perf_counter()
    bst = Booster(model_str=text)
    sm = bst._gbdt._stacked_model()
    assert sm is not None and sm.edges is not None
    print(f"higgs model: {HIGGS_TREES} trees x {HIGGS_LEAVES} leaves, "
          f"loaded and stacked in {time.perf_counter() - t0:.2f} s; "
          f"decision tables {sm.forest.dec.numel() / 1e6:.1f} MB on the "
          f"device")
    torch.cuda.synchronize()
    forest_ops.launches.reset()
    sp.fallbacks.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prob = bst.predict(X)
    torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = forest_ops.launches.value
    fallbacks = sp.fallbacks.value
    assert launches > 0 and fallbacks == 0, (launches, fallbacks)
    assert prob.shape == (HOLDOUT_ROWS,) and np.isfinite(prob).all()
    print(f"higgs predict: {HOLDOUT_ROWS} rows in {e2e:.3f} s end to end "
          f"({HOLDOUT_ROWS / e2e:.0f} rows/s), {launches} launches, "
          f"peak device memory {peak_gb:.3f} GB")

    # every row of the main path's launches: the kernel and its plain
    # version on the same device codes, chunk by chunk as predict cuts
    # them, and the main path's probabilities from the plain scores
    fc = sm.forest
    T = HIGGS_TREES
    k_raw, p_raw = [], []
    for c0 in range(0, HOLDOUT_ROWS, sp.ROW_CHUNK):
        codes = sp.codes_from_x(
            torch.from_numpy(X[c0:c0 + sp.ROW_CHUNK]).to(dev), *sm.edges)
        k_raw.append(forest_ops.forest_predict(codes, fc, 0, T).cpu())
        p_raw.append(forest_ops.forest_predict_plain(codes, fc, 0, T).cpu())
    k_raw, p_raw = torch.cat(k_raw), torch.cat(p_raw)
    assert torch.equal(k_raw, p_raw), "kernel != plain scores"
    max_abs_err = float((k_raw - p_raw).abs().max())
    want = 1.0 / (1.0 + np.exp(-p_raw.numpy()[:, 0].astype(np.float64)))
    assert np.array_equal(prob, want), "main path != plain"
    # leaf mode, and the float64 host walk, on a subset
    fcpu = fc.to("cpu")
    codes = sp.codes_from_x(torch.from_numpy(X[:SUBSET]).to(dev), *sm.edges)
    k_leaves = forest_ops.forest_predict(codes, fc, 0, T, leaf_mode=True)
    p_leaves = forest_ops.forest_predict_plain(codes.cpu(), fcpu, 0, T,
                                               leaf_mode=True)
    assert torch.equal(k_leaves.cpu(), p_leaves), "kernel != plain leaves"
    host = host_raw(bst._gbdt, X[:SUBSET].astype(np.float64))[0]
    err_host = float(np.abs(k_raw.numpy()[:SUBSET, 0] - host).max())
    assert err_host <= 1e-4, f"kernel vs host walk {err_host}"
    print(f"higgs check: kernel == plain scores on all {HOLDOUT_ROWS} rows "
          f"(the main path's probabilities too), leaves on {SUBSET} rows; "
          f"{err_host:.3g} from the float64 host walk")

    # timing at the main path's chunk shape
    higgs = measure_kernel(bst._gbdt, X[:sp.ROW_CHUNK], dev)
    print(f"higgs kernel: {higgs['ms']:.3f} ms per {higgs['rows']}-row "
          f"launch ({higgs['rows'] / higgs['ms'] * 1e3:.0f} rows/s), "
          f"plain {higgs['plain_ms']:.1f} ms, bound {higgs['bound_ms']:.4f} "
          f"ms ({higgs['bound_by']}); {higgs['visits']} node visits "
          f"({higgs['visits'] / higgs['rows'] / T:.2f} per row-tree), "
          f"{higgs['bytes']} bytes")
    walls = wall_ms(lambda: bst.predict(X), 5)
    print(f"higgs predict, 5 more calls: median {np.median(walls):.1f} ms, "
          f"min {min(walls):.1f}, max {max(walls):.1f}")
    wall, busy = device_busy(lambda: bst.predict(X), 3)
    print(f"higgs predict profile, one window of 3 calls: wall {wall:.1f} "
          f"ms, device busy {busy:.2f} ms ({100 * busy / wall:.1f}%); "
          f"host f64 check and f32 cast, timed alone: "
          f"{host_prep_ms(X):.1f} ms")

    # 5. serving: LRB window model through the C API
    Xl = make_lrb_rows(70_000)
    ltext = random_model_text(Xl, LRB_TREES, LRB_LEAVES, 5)
    handle = capi.LGBM_BoosterLoadModelFromString(ltext)
    t0 = time.perf_counter()
    handle.gbdt._stacked_model()
    stack_ms = (time.perf_counter() - t0) * 1e3
    plain = Booster(model_str=ltext, device="cpu")
    torch.cuda.synchronize()
    forest_ops.launches.reset()
    served = []
    for rows in (1, 7, 1000, 65_536):
        Xr = make_lrb_rows(rows, seed=rows)
        t0 = time.perf_counter()
        out = np.asarray(capi.LGBM_BoosterPredictForMat(handle, Xr))
        served.append((rows, (time.perf_counter() - t0) * 1e3))
        assert np.array_equal(out, plain.predict(Xr)), f"lrb {rows} rows"
    torch.cuda.synchronize()
    serve_launches = forest_ops.launches.value
    assert serve_launches > 0 and sp.fallbacks.value == 0
    lrb = measure_kernel(handle.gbdt,
                         make_lrb_rows(65_536).astype(np.float32), dev)
    capi.LGBM_BoosterFree(handle)
    print(f"lrb serving: model stacked in {stack_ms:.1f} ms; "
          + ", ".join(f"{r} rows {t:.2f} ms" for r, t in served)
          + f"; {serve_launches} launches; kernel {lrb['ms']:.4f} ms per "
          f"{lrb['rows']} rows, plain {lrb['plain_ms']:.1f} ms, bound "
          f"{lrb['bound_ms']:.5f} ms ({lrb['bound_by']})")

    # 6-9: training
    train = train_phases(dev)

    # kernels line
    forest = {
        "name": "forest_predict", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/forest_predict.cu",
        "replaces": "lightgbm_tpu/ops/stacked_predict.py:1048",
        "launches": launches, "max_abs_err": max_abs_err,
        "vs_plain": "bitwise", "ms": higgs["ms"],
        "plain_ms": higgs["plain_ms"], "bound_ms": higgs["bound_ms"],
        "bound_by": higgs["bound_by"], "library_ms": None,
        "rows": higgs["rows"], "serve_launches": serve_launches,
        "lrb": {k: lrb[k] for k in ("rows", "ms", "plain_ms", "bound_ms",
                                    "bound_by")}}
    print(json.dumps({"kernels": [forest] + train}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
