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
   plain run as a second reading; times of each kernel (per launch over
   a run of launches between one pair of CUDA events), its plain
   version and the nearest PyTorch library call; for the f32 histogram
   pass the share of rows it counts, its launch plan on this card
   (features per group, slot classes, warps, blocks per SM, grid, row
   ranges) and its slot, histogram and reduce kernels' card time (CUDA
   events at the pass boundaries); K3 and ``index_select`` timed alike
   over 200 launches, with the host's microseconds per call of each;
9. card vs CPU: the LRB parameters at 100,000 rows trained on the card
   and with ``device="cpu"``. The card's tree at the first difference,
   grown again with K1 and K2 swapped for their kernel-order plain
   versions, equals its record bit for bit; the differing split is a
   near tie, within the f32 rounding of the two runs' own gains
   (``explain_difference``); train AUC within 4e-4;
10. HIGGS-shape training on the headline tier, int8 count-proxy
   histograms (``tpu_quantized_hist``, W=64), on phase 7's rows through
   ``train``: ms and launches per iteration, the card's busy share, and
   the holdout AUC within 0.01 of phase 7's exact tier;
11. the LRB window on the int8 tier with exact counts
   (``tpu_count_proxy=0``, W=30) through the C-API sequence, 50
   iterations under bagging, then the next window's 65,536 rows scored;
12. 4-bit packed bins at full width: phase 7's rows at max_bin 15 (16
   bins, two per byte on the card), 10 iterations on the exact tier and
   10 on the count-proxy tier; phases 10-12 capture their first root
   pass and their first and widest wave;
13. the int8 kernels (K2q, K1q) against their plain version on the card
   bit for bit (every channel, K1's leaf ids and cnt_r) and two launches
   bit-identical; each packed launch bit-identical to the unpacked launch
   on the same rows; each variant's time, its plain version's, the
   ``index_add_`` library call (int32 for the int8 tiers) and its bound;
14. card vs CPU on the quantized tier: the LRB parameters with
   ``tpu_quantized_hist`` at 100,000 rows, 20 iterations; trees equal up
   to a near tie of the quantized gains, train AUC within 4e-4;
15. categorical training at full width: 10,000,000 rows (and a 500,000
   row holdout) in the column layout of the airline on-time data of
   szilard/benchm-ml (``make_airline_like``: six categorical columns,
   two numerical), 255 leaves, max_bin 255, the default categorical
   parameters, 10 iterations through ``train`` on the exact tier: ms per
   iteration, K1 launches per iteration and those with categorical
   slots, the card's busy share, the holdout AUC (scored through
   ``Booster.predict``, the forest kernel with no fallback) beside the
   same rows trained with every column numerical;
16. the same rows on ``tpu_quantized_hist`` with ``tpu_count_proxy=1``:
   the tier resolves to int8 with exact counts (W=40) and logs the JAX
   package's warning; 10 iterations;
17. K1 with categorical rows against its plain version at phases 15-16's
   captured inputs (the root pass and the widest wave with a
   categorical slot): the f32 kernel bit for bit against the plain
   version run on the CPU in the kernels' order (every channel, the
   leaf ids; two launches bit-identical), the int8 kernel bit for bit
   against its plain version on the card; times, bounds and the
   ``index_add_`` of one pass; the root pass (K2) timed beside it;
   phase 8's K1 time on phase 7's inputs (the launch without
   categorical rows) not more than 10% above its 7.583 ms before the
   categorical rows existed (PERF.md's kernel table) when the card's
   power limit is 700 W;
18. card vs CPU at 100,000 rows of phase 15's generator, 20 iterations
   of 31 leaves (phase 15's 255 take the CPU about 20 s an iteration),
   on the exact and the int8 tier: trees equal up to a near tie, train
   AUC within 4e-4.

Phases 6-7, 10-12 and 15-16 check that the main path launched each
kernel (and each histogram variant) of its tier. Prints a JSON line of the kernels,
then the last line ``{"ok": true, "device": {...}}``. Any failed check
raises, and the
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
PROXY_AUC_TOL = 0.01            # the count-proxy tier's cost is about 1e-3
PACKED_MAX_BIN = 15             # 16 bins: 4-bit packed
CPU_Q_ITERS = 20
# szilard/benchm-ml's airline set: Month, DayofMonth, DayOfWeek, DepTime,
# UniqueCarrier, Origin, Dest, Distance; None marks a numerical column
AIRLINE_CATEGORIES = (12, 31, 7, None, 22, 300, 300, None)
AIRLINE_CAT_COLUMNS = [j for j, k in enumerate(AIRLINE_CATEGORIES) if k]
AIRLINE_ROWS = 10_000_000
AIRLINE_PARAMS = {"objective": "binary", "metric": "auc", "max_bin": 255,
                  "num_leaves": 255, "learning_rate": 0.1, "verbose": -1}
AIRLINE_ITERS = 10
CAT_CPU_ITERS = 20
CAT_CPU_LEAVES = 31
K1_MS_BEFORE_CAT = 7.583        # PERF.md's table: phase 8's K1, 700 W
K3_RUNS = 200                   # K3 launches per timing window
PASS_RUNS = 5                   # launches per timed f32 pass split


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


def make_airline_like(n_rows: int, seed: int) -> np.ndarray:
    """Rows in the column layout of the airline on-time data
    (``AIRLINE_CATEGORIES``): each categorical column's codes drawn with
    Zipf-like frequencies (p ~ rank^-1.5) under one fixed shuffle of its
    codes, DepTime as hhmm in 1-2400, Distance in miles (30-4962). At
    that skew the 255 most frequent of Origin's and Dest's 300 codes
    hold over 99% of the rows: they get a bin each, the last bin also
    holds the other 45 (bin.cpp's 99% cut), and the bins fit a byte."""
    r = np.random.default_rng(seed)
    shuffle = np.random.default_rng(40)
    X = np.empty((n_rows, len(AIRLINE_CATEGORIES)), np.float64)
    for j, k in enumerate(AIRLINE_CATEGORIES):
        if k:
            p = np.arange(1, k + 1) ** -1.5
            X[:, j] = shuffle.permutation(k)[r.choice(k, n_rows,
                                                      p=p / p.sum())]
    hour = np.clip(np.rint(r.normal(13.5, 4.5, n_rows)), 0, 23)
    X[:, 3] = np.clip(hour * 100 + r.integers(0, 60, n_rows), 1, 2400)
    X[:, 7] = np.clip(np.rint(r.lognormal(6.4, 0.6, n_rows)), 30, 4962)
    return X


def airline_labels(X: np.ndarray, seed: int) -> np.ndarray:
    """dep_delayed_15min from a seeded rule: a scrambled 30% of the
    origins and of the carriers, later departures, logistic noise
    (``seed``)."""
    rule = np.random.default_rng(42)
    late_origin = rule.random(AIRLINE_CATEGORIES[5]) < 0.3
    late_carrier = rule.random(AIRLINE_CATEGORIES[4]) < 0.3
    logit = (1.1 * late_origin[X[:, 5].astype(np.int64)]
             + 0.8 * late_carrier[X[:, 4].astype(np.int64)]
             + 0.0009 * (X[:, 3] - 1400.0) - 1.0)
    noise = np.random.default_rng(seed).logistic(size=X.shape[0])
    return (logit + noise > 0).astype(np.float32)


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
    """Milliseconds per call of ``fn``: ``runs`` calls after ``warmup``,
    between one pair of CUDA events, over ``runs`` (a call's host time
    overlaps the card's work on the calls before it)."""
    import torch
    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(runs):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / runs


def host_us(fn, runs: int) -> float:
    """Host microseconds per call of ``fn`` over ``runs`` calls (what
    enqueueing a launch costs the host), then a synchronize."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / runs
    torch.cuda.synchronize()
    return us


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


def host_ops(fn, runs: int, k: int = 6) -> str:
    """The ``k`` operators with the most host time over ``runs`` calls of
    ``fn`` (torch.profiler's self CPU time, per call, with their counts
    per call): where the host's part of an iteration goes."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    ev = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return ", ".join(f"{e.key} {e.self_cpu_time_total / 1e3 / runs:.2f} ms "
                     f"x{e.count // runs}" for e in ev[:k])


def host_prep_ms(X: np.ndarray) -> float:
    """Host time of predict's first step at this input: the float64 view
    and the f32-exactness check that picks device binning."""
    from lightgbm_tpu_torch.ops import stacked_predict as sp
    t0 = time.perf_counter()
    X64 = np.ascontiguousarray(np.asarray(X, np.float64))
    assert sp._f32_exact(X64, X64.astype(np.float32))
    return (time.perf_counter() - t0) * 1e3


def _clone(a):
    import torch
    if torch.is_tensor(a):
        return a.clone()
    if isinstance(a, tuple):
        return tuple(_clone(x) for x in a)
    return a


class Capture:
    """Calls ``fn`` and keeps clones of the tensor arguments (positional
    ``args``, keyword ``kw``) of its first call, or with ``key``, of the
    first call with the largest ``key(args)`` (cloned before the call: K3
    updates its scores in place)."""

    def __init__(self, fn, key=None):
        self.fn = fn
        self.key = key
        self.args = None
        self.kw = {}
        self.best = None
        self.hits = 0          # calls whose key is >= 0

    def __call__(self, *args, **kw):
        k = None if self.key is None else self.key(args)
        self.hits += k is not None and k >= 0
        if self.args is None or (k is not None and k > self.best):
            self.args = _clone(args)
            self.kw = {name: _clone(v) for name, v in kw.items()}
            self.best = k
        return self.fn(*args, **kw)


def _categorical_width(args) -> int:
    """A K1 call's wave width if its split table has a categorical slot,
    else -1 (reads the slots' flags back from the card)."""
    from lightgbm_tpu_torch.ops import hist_wave as hw
    tbl = args[5]
    if tbl.shape[0] <= hw.TBL_ROWS_NUM or not bool(
            tbl[hw.TBL_ISCAT].any()):
        return -1
    return tbl.shape[1]


@contextlib.contextmanager
def capturing():
    """While active, the grower's K1 and K2 calls and the boosting loop's
    K3 call go through Captures: K2's first call (the first root pass),
    K1's first, its widest and its widest with a categorical slot ("K1c",
    whose ``hits`` count the waves with categorical slots), K3's first.
    Yields them by name."""
    from lightgbm_tpu_torch.models import gbdt as gbdt_mod
    from lightgbm_tpu_torch.ops import wave_grower as wg
    k1 = Capture(wg.fused_partition_histogram)
    caps = {"K1": k1, "K2": Capture(wg.wave_histogram),
            "K3": Capture(gbdt_mod.add_leaf_outputs),
            "K1w": Capture(k1, key=lambda a: a[5].shape[1])}
    caps["K1c"] = Capture(caps["K1w"], key=_categorical_width)
    wg.fused_partition_histogram = caps["K1c"]
    wg.wave_histogram = caps["K2"]
    gbdt_mod.add_leaf_outputs = caps["K3"]
    try:
        yield caps
    finally:
        wg.fused_partition_histogram = k1.fn
        wg.wave_histogram = caps["K2"].fn
        gbdt_mod.add_leaf_outputs = caps["K3"].fn


def bound(nbytes: float, ops: float) -> dict:
    """The least time for a function: bytes over HBM bandwidth or its
    operations over the rate of the CUDA cores (f32, and int32 adds,
    counted at the same rate), whichever is larger."""
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


def plain_in_kernel_order(plain, args):
    """``plain(*args)`` in the f32 kernels' order of addition, on the
    CPU (``hist_wave.plain_in_kernel_order``); ``plain`` passes keywords
    on to a plain histogram version."""
    from lightgbm_tpu_torch.ops import hist_wave as hw
    return hw.plain_in_kernel_order(plain, *args)


def plain_kw(kw: dict) -> dict:
    """A wrapper's keyword arguments as its plain version takes them."""
    return {k: kw[k] for k in ("count_proxy", "packed4", "num_features",
                               "any_cat") if k in kw}


def kernel_raw(kernel, kw: dict):
    """``kernel`` with the captured keywords and no dequantization: the
    raw sums the kernel writes."""
    kw = dict(kw, gh_scale=None)
    return lambda *a: kernel(*a, **kw)


def check_histogram(name, kernel, plain, args, hist_of, slots_of):
    """One histogram kernel (K1 or K2) on captured main-path inputs
    ``args`` (bins_t, g, h, ...): two launches bit-identical, and every
    channel (and K1's leaf ids) bit for bit equal to the plain version
    (``plain``, which passes keywords on) run on the CPU in the kernels'
    order of addition. A second reading,
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


def lib_index_add(args, dev, kw=None):
    """The K2 yardstick: one ``index_add_`` of the channels on a flat index
    built beforehand (the plain version's scatter): f32 for the f32 tier,
    int32 (g, h and, with exact counts, 1) for the int8 tier; packed bins
    are indexed as their unpacked features."""
    import torch
    from lightgbm_tpu_torch.ops import hist_wave as hw
    kw = kw or {}
    bins_t, g, h, leaf, wl, B = args
    if kw.get("packed4"):
        bins_t = hw.unpack4(bins_t, kw["num_features"])
    F, n = bins_t.shape
    W = wl.shape[0]
    eq = (leaf[None, :] == wl[:, None]) & (wl >= 0)[:, None]
    base = torch.where(eq.any(0), torch.argmax(eq.to(torch.uint8), 0)
                       * (F * B), W * F * B)
    flat = (base[None, :] + torch.arange(F, device=dev)[:, None] * B
            + bins_t.long()).reshape(-1)
    dt = torch.int32 if g.dtype == torch.int8 else torch.float32
    chans = [g.to(dt), h.to(dt), torch.ones((), dtype=dt, device=dev)]
    chans = chans[:2] if kw.get("count_proxy") else chans
    vals = torch.stack([c.expand(F, n) for c in chans], -1).reshape(
        -1, len(chans))
    out = torch.zeros(((W + 1) * F * B, len(chans)), dtype=dt, device=dev)

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
    from lightgbm_tpu_torch.ops.f32math import fma
    gb = booster._gbdt
    assert gb._grower_cfg.precision == "f32"
    dev = gb.train_data.bins_t.device
    saved = wg.wave_histogram, wg.fused_partition_histogram

    def swap(plain):
        return lambda *a, gh_scale=None, precision="f32", **kw: \
            hw.plain_in_kernel_order(plain, *a, **plain_kw(kw))
    wg.wave_histogram = swap(hw.wave_histogram_plain)
    wg.fused_partition_histogram = swap(hw.fused_partition_histogram_plain)
    try:
        rec, _ = wg.WaveGrower.grow(gb._grower, gb.train_data.bins_t,
                                    *[x.to(dev) for x in inputs[t]])
    finally:
        wg.wave_histogram, wg.fused_partition_histogram = saved
    shrink = float(np.float32(gb.shrinkage_rate))
    return rec._replace(
        leaf_output=fma(rec.leaf_output, shrink, 0.0),
        internal_value=fma(rec.internal_value, shrink, 0.0)).to_numpy()


def explain_difference(runs: dict, t: int, i: int,
                       quantized: bool = False) -> dict:
    """Both runs' split number ``i`` of tree ``t`` (their first
    difference), each evaluated in float64 on each run's own grower
    inputs of that tree: the candidate's gain (l1 = 0), its two sides'
    hessian sums and counts. The trees agree on splits 0..i-1, so both
    candidates see the same leaf membership.

    The verdict is a near tie when the candidates' float64 gains differ
    by less than the f32 rounding that the two runs' own gains carry:
    each run's recorded f32 gain of its choice against that choice's
    float64 gain on its inputs, added over the two runs (a categorical
    candidate's gain adds cat_l2 to l2 in sorted mode, as the split
    search does). A leaf's f32
    histogram comes from its ancestors' by subtraction and carries their
    rounding, and two orders of addition can rank candidates that close
    either way. It is a hessian-boundary tie when a side's hessian sum
    lies within 1e-5 of min_sum_hessian_in_leaf, where f32 rounding
    decides validity. With ``quantized`` the gains are those of the
    tree's quantized g and h (ops/quantize.py, the same on both devices),
    dequantized, which is what that tier's splits maximise."""
    import torch
    from lightgbm_tpu_torch.ops.quantize import quantize
    from lightgbm_tpu_torch.ops.partition import row_goes_right
    from lightgbm_tpu_torch.ops.predict import replay_partition
    gb = runs["cpu"][0]._gbdt
    cfg, meta = gb.config, gb._grower.meta
    bins = gb.train_data.bins_t
    recs = {w: runs[w][0]._gbdt.records[t].to_numpy() for w in runs}
    cand = {w: tuple(int(r[k][i]) for k in ("split_leaf", "split_feature",
                                             "split_bin",
                                             "split_default_left",
                                             "split_is_cat"))
            + (tuple(int(x) for x in r["split_cat_words"][i]),)
            for w, r in recs.items()}
    leaf = replay_partition(gb.records[t]._replace(num_leaves=i + 1), bins,
                            meta)
    table = {}
    for src in runs:
        g, h, mask = runs[src][3][t][:3]
        if quantized:
            q = quantize(g.float() * mask, h.float() * mask)
            g = q.gq.double() * float(q.sg)
            h = q.hq.double() * float(q.sh)
        else:
            g, h = g.double() * mask.double(), h.double() * mask.double()
        for w, (lf, f, b, dl, ic, cw) in cand.items():
            rows = (leaf == lf) & (mask > 0)
            right = row_goes_right(bins[f].to(torch.int32), b, bool(dl),
                                   int(meta.missing_type[f]),
                                   int(meta.default_bin[f]),
                                   int(meta.num_bin[f]), bool(ic),
                                   torch.tensor(cw, dtype=torch.int32,
                                                device=bins.device))
            # a categorical split in sorted mode adds cat_l2
            l2 = cfg.lambda_l2 + (cfg.cat_l2 if ic and int(meta.num_bin[f])
                                  > cfg.max_cat_to_onehot else 0.0)
            side = {}
            for name, m in (("left", rows & ~right), ("right", rows & right)):
                side[name] = (float(g[m].sum()), float(h[m].sum()),
                              int(m.sum()))
            gl, hl, nl = side["left"]
            gr, hr, nr = side["right"]
            gain = (gl * gl / (hl + l2) + gr * gr / (hr + l2)
                    - (gl + gr) ** 2 / (hl + hr + l2))
            table[(src, w)] = {"leaf": lf, "feature": f, "bin": b,
                               "categorical": bool(ic), "gain": gain,
                               "hess": (hl, hr), "count": (nl, nr)}
    rounding = sum(abs(float(recs[w]["split_gain"][i]) - table[(w, w)]["gain"])
                   for w in runs)
    gap = max(abs(table[(src, "cuda")]["gain"] - table[(src, "cpu")]["gain"])
              for src in runs)
    msh = cfg.min_sum_hessian_in_leaf
    boundary = any(abs(hs - msh) <= 1e-5 * msh
                   for v in table.values() for hs in v["hess"])
    return {"table": table, "gap": gap, "rounding": rounding,
            "gain_tie": gap <= rounding, "hessian_boundary": boundary}


def card_and_cpu(params: dict, X, y, iters: int, **ds_kw) -> dict:
    """``iters`` ``Booster.update`` calls from the same rows on the card
    and with ``device="cpu"``: {"cuda" | "cpu": (booster, train metrics,
    seconds, each tree's grower inputs on the CPU)}; the inputs let
    ``explain_difference`` attribute a first difference."""
    import lightgbm_tpu_torch as lgt
    runs = {}
    for where in ("cuda", "cpu"):
        t0 = time.perf_counter()
        b = lgt.Booster(params, lgt.Dataset(X, label=y, **ds_kw),
                        device=None if where == "cuda" else "cpu")
        grower = b._gbdt._grower
        inputs = []

        def grow(*args, _grow=grower.grow, _inputs=inputs):
            _inputs.append([a.cpu() for a in args[1:]])
            return _grow(*args)
        grower.grow = grow
        for _ in range(iters):
            b.update()
        b.model_to_string()
        runs[where] = (b, dict((m, v) for _, m, v, _ in b.eval_train()),
                       time.perf_counter() - t0, inputs)
    return runs


def judge_trees(runs: dict, quantized: bool = False) -> tuple:
    """The card's trees against the CPU's: equal, or equal up to a first
    difference that ``explain_difference`` finds a near tie; train AUC
    within AUC_TOL. Returns (tree_diff's result, a line saying where the
    trees part)."""
    gm, cm = runs["cuda"][0]._gbdt.models, runs["cpu"][0]._gbdt.models
    assert len(gm) == len(cm), (len(gm), len(cm))
    diff = tree_diff(gm, cm)
    d_auc = abs(runs["cuda"][1]["auc"] - runs["cpu"][1]["auc"])
    assert d_auc <= AUC_TOL, f"card vs CPU auc differs by {d_auc}"
    if diff is None:
        where = f"all {len(gm)} trees equal in structure and counts"
        if (runs["cuda"][0].model_to_string()
                == runs["cpu"][0].model_to_string()):
            where += "; model text byte-equal"
        return diff, where
    t, i, ga, gc = diff
    why = explain_difference(runs, t, i, quantized)
    for (src, w), v in why["table"].items():
        rule = ("in a categorical left set" if v["categorical"]
                else f"<= bin {v['bin']}")
        print(f"  tree {t} split {i} chosen on the {w}: leaf {v['leaf']}, "
              f"feature {v['feature']} {rule}; on the {src} run's "
              f"gradients: gain {v['gain']:.9g}, hessian sums "
              f"{v['hess'][0]:.9g} | {v['hess'][1]:.9g}, rows "
              f"{v['count'][0]} | {v['count'][1]}")
    print(f"  float64 gain gap {why['gap']:.6g}; the f32 rounding of the "
          f"two runs' own gains {why['rounding']:.6g}")
    assert why["gain_tie"] or why["hessian_boundary"], \
        f"card and CPU trees differ at tree {t} split {i}, not a tie"
    kind = ("a near tie in gain" if why["gain_tie"] else
            "a hessian sum at min_sum_hessian_in_leaf")
    return diff, (f"trees equal up to tree {t}, split {i}, {kind} (split "
                  f"gains {ga:.7g} on the card, {gc:.7g} on the CPU)")


def check_leaf_gather(args) -> dict:
    """K3 on a captured score update (scores, leaf ids, leaf outputs,
    shrinkage): bit for bit against its plain version, with its time, its
    plain version's, the library call ``table.index_select(0, leaf_ids)``
    (the gather alone, 8 bytes a row against K3's 12, for ids in range)
    and the bound. K3 and the library call are timed alike, over a run of
    K3_RUNS launches between one pair of events; the host's microseconds
    per call of each are a second reading."""
    import torch
    from lightgbm_tpu_torch.ops import predict as pr
    sc, leaf, table, shrink = args
    n = sc.shape[0]
    got = pr.add_leaf_outputs(sc.clone(), leaf, table, shrink)
    want = pr.add_leaf_outputs_plain(sc.clone(), leaf, table, shrink)
    assert torch.equal(got, want), "K3 != plain"
    s1, s2 = sc.clone(), sc.clone()

    def k3():
        pr.add_leaf_outputs(s1, leaf, table, shrink)

    def lib():
        table.index_select(0, leaf)
    return dict(
        max_abs_err=0.0, shape=f"N={n}, L={table.shape[0]}",
        ms=cuda_ms(k3, K3_RUNS, warmup=5),
        plain_ms=cuda_ms(
            lambda: pr.add_leaf_outputs_plain(s2, leaf, table, shrink), 20),
        library_ms=cuda_ms(lib, K3_RUNS, warmup=5),
        host_us=host_us(k3, K3_RUNS), library_host_us=host_us(lib, K3_RUNS),
        **bound(12 * n + 4 * table.shape[0], 2 * n))


def pass_report(label: str, kid: str, fn, args, kw: dict,
                counted: int) -> dict:
    """The f32 histogram pass of a captured K2 or K1 launch
    (``fn(*args)``): its plan on this card (features per group Fg, slot
    classes, warps, blocks resident per SM, grid, row ranges), the share
    of rows it counts, and the card's time in its slot, histogram and
    reduce kernels, from CUDA events the launch records at its pass
    boundaries (``hist_wave.pass_times``, PASS_RUNS launches;
    torch.profiler drops these kernels' records in the later phases of
    this long run). Prints one line; returns them."""
    from lightgbm_tpu_torch.ops import hist_wave as hw
    bins_t, B = args[0], args[-1]
    F = kw.get("num_features") or bins_t.shape[0]
    n = bins_t.shape[1]
    W = args[4].shape[0] if kid == "K2" else args[5].shape[1]
    lp = hw.launch_plan(n, F, W, B, bool(kw.get("packed4")), bins_t.device)
    fn(*args)
    split = hw.pass_times(lambda: fn(*args), PASS_RUNS)
    print(f"  {label} {kid} f32 pass: counts {counted} of {n} rows "
          f"({counted / max(n, 1):.4f}); Fg {lp['fg']} of {F} features, "
          f"{lp['classes']} slot classes, {lp['warps']} warps a block, "
          f"{lp['blocks_per_sm']} blocks/SM, grid {lp['grid']}, "
          f"{lp['ranges']} ranges of {lp['rows_per_range']} rows; card ms "
          "a launch: " + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    return {"counted_share": counted / max(n, 1), "split_ms": split,
            "plan": {k: lp[k] for k in ("fg", "classes", "warps",
                                         "blocks_per_sm", "grid", "ranges",
                                         "rows_per_range")}}


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
    kw2, kw1 = caps["K2"].kw, caps["K1w"].kw
    bins_t, B = a2[0], a2[-1]
    F, n = bins_t.shape
    out = {}

    def k2(*a):
        return hw.wave_histogram(*a, **kw2)

    def p2(*a, **k):
        return hw.wave_histogram_plain(*a, **plain_kw(kw2), **k)

    def k1(*a):
        return hw.fused_partition_histogram(*a, **kw1)

    def p1(*a, **k):
        return hw.fused_partition_histogram_plain(*a, **plain_kw(kw1), **k)
    st2 = check_histogram("K2", k2, p2, a2, lambda o: o, None)
    W2 = a2[4].shape[0]
    out["K2"] = dict(
        st2, shape=f"F={F}, N={n}, W={W2}, B={B}",
        ms=cuda_ms(lambda: k2(*a2), 5),
        plain_ms=cuda_ms(lambda: p2(*a2), 3),
        library_ms=lib_index_add(a2, dev),
        **pass_report(label, "K2", k2, a2, kw2, st2["rows_counted"]),
        **bound(F * n + 12 * n + 4 * W2 + 12 * W2 * F * B,
                3 * F * st2["rows_counted"]))
    first = check_histogram("K1", k1, p1, caps["K1"].args, lambda o: o[1],
                            lambda o: o[0])
    st1 = check_histogram("K1", k1, p1, a1, lambda o: o[1], lambda o: o[0])
    W1 = a1[5].shape[1]
    out["K1"] = dict(
        st1, shape=f"F={F}, N={n}, W={W1}, B={B}",
        first_wave={"W": caps["K1"].args[5].shape[1],
                    "max_abs_err_f64": first["max_abs_err_f64"]},
        in_bag_rows=int((a1[3] > 0).sum()),
        ms=cuda_ms(lambda: k1(*a1), 5),
        plain_ms=cuda_ms(lambda: p1(*a1), 3),
        library_ms=None,
        **pass_report(label, "K1", k1, a1, kw1, st1["rows_counted"]),
        **bound(F * n + 20 * n + 36 * W1 + 12 * W1 * F * B,
                n + 3 * F * st1["rows_counted"]))
    out["K3"] = check_leaf_gather(caps["K3"].args)
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
    print(f"{label} K3 at [{k['shape']}]: {k['ms']:.4f} ms a launch over "
          f"{K3_RUNS} ({100 * k['bound_ms'] / k['ms']:.0f}% of the bound), "
          f"plain {k['plain_ms']:.4f} ms, library (index_select, the "
          f"gather alone) {k['library_ms']:.4f} ms over {K3_RUNS}, bound "
          f"{k['bound_ms']:.4f} ms ({k['bound_by']}); host {k['host_us']:.1f}"
          f" us a call (index_select {k['library_host_us']:.1f}); bit-equal "
          f"to plain")
    return out


def _counters() -> dict:
    from lightgbm_tpu_torch.ops import forest as forest_ops
    from lightgbm_tpu_torch.ops import hist_wave as hw
    from lightgbm_tpu_torch.ops import predict as pr
    out = {"K2": hw.k2_launches, "K1": hw.k1_launches, "K3": pr.launches,
           "K4": forest_ops.launches, "K1/cat": hw.k1_cat_launches}
    for v in hw.VARIANTS:
        out[f"K2/{v}"] = hw.k2_variant_launches[v]
        out[f"K1/{v}"] = hw.k1_variant_launches[v]
    return out


def reset_counts() -> None:
    """Sets every kernel's launch count (and each histogram variant's) to
    0, after the card has finished what it was given."""
    import torch
    torch.cuda.synchronize()
    for c in _counters().values():
        c.reset()


def read_counts() -> dict:
    """Launches since ``reset_counts``: K1, K2, K3 and K4 in all, and each
    histogram variant launched at least once ("K2/proxy", ...)."""
    import torch
    torch.cuda.synchronize()
    return {k: c.value for k, c in _counters().items()
            if c.value or "/" not in k}


def train_phases(dev) -> tuple:
    """Phases 6-9 of the module docstring. Returns the kernels-line
    entries of K2, K1 and K3, and phase 7's rows and holdout AUC for the
    quantized phases."""
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import capi
    reset, read = reset_counts, read_counts

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
          f"device busy {busy:.2f} ms ({100 * busy / wall:.1f}%); host time "
          f"per iteration by operator: "
          f"{host_ops(lambda: capi.LGBM_BoosterUpdateOneIter(bst), 3)}")
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
    del bst, ds
    higgs_data = {"X": X, "y": y, "Xt": Xt, "yt": yt, "auc": auc_t}

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
    runs = card_and_cpu(TRAIN_PARAMS, X, y,
                        int(TRAIN_PARAMS["num_iterations"]))
    diff, where = judge_trees(runs)
    gm = runs["cuda"][0]._gbdt.models
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
    print(f"card vs CPU, {CPU_ROWS} LRB rows x {len(gm)} iterations: {where};"
          f" train auc {runs['cuda'][1]['auc']:.6f} vs "
          f"{runs['cpu'][1]['auc']:.6f} (within {AUC_TOL}); "
          f"{runs['cuda'][2]:.1f} s on the card, {runs['cpu'][2]:.1f} s on "
          f"the CPU")

    out = []
    src = "lightgbm_tpu_torch/csrc/"
    notes = {"K2": ("index_add_ of the three channels on a flat index "
                    "built beforehand"),
             "K1": ("no single PyTorch call partitions rows and builds "
                    "their histograms"),
             "K3": ("table.index_select(0, leaf_ids): the gather alone, "
                    "for ids in range")}
    keep = ("shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err", "max_abs_err_f64", "counted_share", "split_ms",
            "plan", "host_us", "library_host_us")
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
            "launches": (lrb_counts[kid] + higgs_counts[kid]
                         if kid == "K3" else lrb_counts[f"{kid}/f32"]
                         + higgs_counts[f"{kid}/f32"]),
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
            **{f: k[f] for f in keep[8:] if f in k},
            **({} if kid == "K3" else
               {"max_abs_err_f64": k["max_abs_err_f64"]})})
    return out, higgs_data


def check_int_histogram(name, kernel, plain, args, kw, outs_of) -> None:
    """An int8-tier kernel (K2q or K1q) on captured main-path inputs: two
    raw launches bit-identical and equal, every output (sums, and K1's
    leaf ids and cnt_r), to the plain version run on the card, whose
    integer sums do not depend on order."""
    import torch
    raw = kernel_raw(kernel, kw)
    out1, out2 = outs_of(raw(*args)), outs_of(raw(*args))
    want = outs_of(plain(*args, **plain_kw(kw)))
    torch.cuda.synchronize()
    assert len(out1) == len(want), name
    for a, b, c in zip(out1, out2, want):
        assert torch.equal(a, b), f"{name}: two launches differ"
        assert torch.equal(a, c), f"{name}: differs from the plain version"


def check_packed(name, kernel, args, kw, outs_of) -> None:
    """A packed launch (4-bit bins, two per byte) against the unpacked
    launch on the same rows: bit-identical outputs."""
    import torch
    from lightgbm_tpu_torch.ops import hist_wave as hw
    raw = kernel_raw(kernel, kw)
    unpacked = dict(kw, packed4=False)
    flat = hw.unpack4(args[0], kw["num_features"]).contiguous()
    got = outs_of(raw(*args))
    want = outs_of(kernel_raw(kernel, unpacked)(flat, *args[1:]))
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b), f"{name}: packed launch != unpacked launch"


def time_histogram(kid, caps_key, caps, dev, label="") -> dict:
    """Times (kernel, plain version on the card, library call) and the
    bound of a captured K2 or K1 launch of any tier, at its shapes, and
    for the f32 tier its ``pass_report`` (under ``label``). The
    bytes: each row's bins (one byte per feature, half under packed4),
    g and h (4 bytes each, 1 in the int8 tier), its leaf id (K1: in and
    out, and the bag mask), the split table and the output; the
    operations: one add per (row, feature, channel) counted, and K1's
    partition of every row."""
    import torch
    from lightgbm_tpu_torch.ops import hist_wave as hw
    cap = caps[caps_key]
    a, kw = cap.args, cap.kw
    bins_t, g, B = a[0], a[1], a[-1]
    F = kw.get("num_features") or bins_t.shape[0]
    n = bins_t.shape[1]
    C = 2 if kw.get("count_proxy") else 3
    fn, plain = ((hw.wave_histogram, hw.wave_histogram_plain) if kid == "K2"
                 else (hw.fused_partition_histogram,
                       hw.fused_partition_histogram_plain))
    # rows the pass counts, from the count channel of the 3-channel sums
    full = plain(*a, **dict(plain_kw(kw), count_proxy=False))
    full = full if kid == "K2" else full[1]
    counted = int(full[:, 0, :, 2].sum())
    W = a[4].shape[0] if kid == "K2" else a[5].shape[1]
    bin_bytes = ((F + 1) // 2 if kw.get("packed4") else F) * n
    io_bytes = (2 * g.element_size() + (4 if kid == "K2" else 12)) * n
    nbytes = (bin_bytes + io_bytes + 4 * a[4 if kid == "K2" else 5].numel()
              + W * F * B * C * 4)
    ops = C * F * counted + (n if kid == "K1" else 0)
    raw = kernel_raw(fn, kw)
    extra = {}
    if g.dtype == torch.float32:
        extra = pass_report(label, kid, raw, a, kw, counted)
    if kw.get("packed4"):
        flat = hw.unpack4(bins_t, F).contiguous()
        unpacked = kernel_raw(fn, dict(kw, packed4=False))
        extra["unpacked_ms"] = cuda_ms(lambda: unpacked(flat, *a[1:]), 5)
    return dict(
        extra, shape=f"F={F}, N={n}, W={W}, B={B}, C={C}"
        + (", packed" if kw.get("packed4") else ""),
        ms=cuda_ms(lambda: raw(*a), 5),
        plain_ms=cuda_ms(lambda: plain(*a, **plain_kw(kw)), 3),
        library_ms=lib_index_add(a, dev, kw) if kid == "K2" else None,
        **bound(nbytes, ops))


def quant_phases(dev, higgs: dict) -> list:
    """Phases 10-14 of the module docstring: the int8 tiers and 4-bit
    packed bins. ``higgs`` holds phase 7's rows and exact-tier holdout
    AUC. Returns the kernels-line entries of every quantized and packed
    histogram variant."""
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import capi
    from lightgbm_tpu_torch.ops import hist_wave as hw
    X, y, Xt, yt = higgs["X"], higgs["y"], higgs["Xt"], higgs["yt"]
    runs = {}

    def train_higgs(label, params, variant):
        """train() on phase 7's rows, capturing the first root pass and
        the first and widest wave; checks the variant ran."""
        with capturing() as caps:
            reset_counts()
            t0 = time.perf_counter()
            ds = lgt.Dataset(X, label=y, params=params).construct()
            torch.cuda.synchronize()
            bin_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            bst = lgt.train(params, ds, num_boost_round=HIGGS_ITERS)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            counts = read_counts()
        for k in (f"K2/{variant}", f"K1/{variant}", "K3"):
            assert counts.get(k, 0) > 0, (label, counts)
        cfg = bst._gbdt._grower_cfg
        prob = bst.predict(Xt)
        assert prob.shape == (HOLDOUT_ROWS,) and np.isfinite(prob).all()
        auc = auc_np(yt, prob)
        wall, busy = device_busy(bst.update, 2)
        per_it = {k: v / HIGGS_ITERS for k, v in counts.items()}
        print(f"{label}: {HIGGS_TRAIN_ROWS} x 28, {HIGGS_ITERS} iterations,"
              f" W={cfg.wave_size}, B={cfg.num_bins}, precision "
              f"{cfg.precision}, count-proxy {cfg.count_proxy}, packed4 "
              f"{cfg.packed4}; binning {bin_s:.2f} s; "
              f"{1e3 * train_s / HIGGS_ITERS:.1f} ms/iteration; holdout auc "
              f"{auc:.5f}; launches per iteration {per_it}; profile of 2 "
              f"iterations: wall {wall:.1f} ms, device busy {busy:.2f} ms "
              f"({100 * busy / wall:.1f}%)")
        runs[label] = {"caps": caps, "counts": counts, "auc": auc,
                       "ms_per_iteration": 1e3 * train_s / HIGGS_ITERS,
                       "busy": busy / wall}
        return bst, cfg

    # 10. the headline tier: int8 count-proxy histograms at the HIGGS shape
    bst, cfg = train_higgs("higgs proxy", {**HIGGS_PARAMS,
                                           "tpu_quantized_hist": True},
                           "proxy")
    assert (cfg.precision, cfg.count_proxy, cfg.wave_size) == (
        "int8", True, 64), cfg
    gap = abs(runs["higgs proxy"]["auc"] - higgs["auc"])
    assert gap <= PROXY_AUC_TOL, f"proxy tier auc {gap} from the exact tier"
    print(f"  holdout auc: count-proxy {runs['higgs proxy']['auc']:.5f}, "
          f"exact {higgs['auc']:.5f} (|diff| {gap:.2g} <= {PROXY_AUC_TOL})")
    del bst

    # 11. the LRB window on the int8 tier with exact counts, C API
    Xl = make_lrb_rows(LRB_TRAIN_ROWS, seed=21)
    yl = lrb_labels(Xl, seed=22)
    Xn = make_lrb_rows(LRB_NEXT_ROWS, seed=23)
    yn = lrb_labels(Xn, seed=24)
    params = {**TRAIN_PARAMS, "tpu_quantized_hist": "true",
              "tpu_count_proxy": "0"}
    with capturing() as caps:
        reset_counts()
        ds = capi.LGBM_DatasetCreateFromMat(Xl, parameters=params)
        capi.LGBM_DatasetSetField(ds, "label", yl)
        bst = capi.LGBM_BoosterCreate(ds, params)
        iters = []
        for _ in range(int(params["num_iterations"])):
            t1 = time.perf_counter()
            finished = capi.LGBM_BoosterUpdateOneIter(bst)
            torch.cuda.synchronize()
            iters.append(time.perf_counter() - t1)
            if finished:
                break
        evals = dict(capi.LGBM_BoosterGetEval(bst, 0))
        text = capi.LGBM_BoosterSaveModelToString(bst)
        pred = np.asarray(capi.LGBM_BoosterPredictForMat(bst, Xn))
        counts = read_counts()
    cfg = bst.gbdt._grower_cfg
    assert pred.shape == (LRB_NEXT_ROWS,) and np.isfinite(pred).all()
    host = host_raw(lgt.Booster(model_str=text, device="cpu")._gbdt,
                    Xn[:SUBSET])[0]
    err_host = float(np.abs(pred[:SUBSET] - 1 / (1 + np.exp(-host))).max())
    assert err_host <= 1e-5, f"lrb int8 model text: {err_host} from host walk"
    assert (cfg.precision, cfg.count_proxy, cfg.wave_size) == (
        "int8", False, 30), cfg
    for k in ("K2/int8", "K1/int8", "K3"):
        assert counts.get(k, 0) > 0, counts
    assert bool((caps["K1w"].args[3] == 0).any()), "no out-of-bag rows"
    assert evals["auc"] > 0.6 and text.startswith("tree"), evals
    wall, busy = device_busy(lambda: capi.LGBM_BoosterUpdateOneIter(bst), 3)
    top = host_ops(lambda: capi.LGBM_BoosterUpdateOneIter(bst), 3)
    n_it = len(iters)
    print(f"lrb int8: {LRB_TRAIN_ROWS} x {LRB_FEATURES}, {n_it} iterations, "
          f"W={cfg.wave_size}, B={cfg.num_bins}; median "
          f"{1e3 * float(np.median(iters)):.1f} ms/iteration; train auc "
          f"{evals['auc']:.5f}; next window auc {auc_np(yn, pred):.5f}, "
          f"model text scores within {err_host:.2g} of the host walk; "
          f"launches per iteration "
          f"{ {k: v / n_it for k, v in counts.items()} }; profile of 3 "
          f"iterations: wall {wall:.1f} ms, device busy {busy:.2f} ms "
          f"({100 * busy / wall:.1f}%); host time per iteration by "
          f"operator: {top}")
    runs["lrb int8"] = {"caps": caps, "counts": counts, "iters": n_it}
    capi.LGBM_BoosterFree(bst)
    del Xl, Xn, ds, bst

    # 12. 4-bit packed bins at full width: the exact tier, then count-proxy
    for label, extra, variant in (
            ("higgs packed exact", {}, "f32_packed4"),
            ("higgs packed proxy", {"tpu_quantized_hist": True},
             "proxy_packed4")):
        bst, cfg = train_higgs(label, {**HIGGS_PARAMS, **extra,
                                       "max_bin": PACKED_MAX_BIN}, variant)
        assert cfg.packed4 and cfg.num_bins == 16, cfg
        assert bst._gbdt.train_data.packed4
        del bst

    # 13. the kernels on those captures
    t0 = time.perf_counter()
    out = {}
    for label, variant in (("higgs proxy", "proxy"), ("lrb int8", "int8"),
                           ("higgs packed exact", "f32_packed4"),
                           ("higgs packed proxy", "proxy_packed4")):
        caps = runs[label]["caps"]
        for kid, key, fn, plain, outs_of in (
                ("K2", "K2", hw.wave_histogram, hw.wave_histogram_plain,
                 lambda o: (o,)),
                ("K1", "K1", hw.fused_partition_histogram,
                 hw.fused_partition_histogram_plain, lambda o: tuple(o)),
                ("K1", "K1w", hw.fused_partition_histogram,
                 hw.fused_partition_histogram_plain, lambda o: tuple(o))):
            cap = caps[key]
            if variant != "f32_packed4":
                check_int_histogram(f"{label} {key}", fn, plain, cap.args,
                                    cap.kw, outs_of)
            if variant.endswith("packed4"):
                check_packed(f"{label} {key}", fn, cap.args, cap.kw, outs_of)
        for kid, key in (("K2", "K2"), ("K1", "K1w")):
            t = time_histogram(kid, key, caps, dev, label)
            t["launches"] = runs[label]["counts"][f"{kid}/{variant}"]
            t["launches_per_iteration"] = t["launches"] / runs[label].get(
                "iters", HIGGS_ITERS)
            out[(kid, variant)] = t
            lib = t["library_ms"]
            print(f"{label} {kid} [{t['shape']}]: {t['ms']:.3f} ms, plain "
                  f"{t['plain_ms']:.3f} ms, library "
                  f"{'none' if lib is None else f'{lib:.3f} ms'}, bound "
                  f"{t['bound_ms']:.4f} ms ({t['bound_by']}); "
                  f"{t['launches_per_iteration']:.2f} launches/iteration"
                  + (f"; the unpacked launch {t['unpacked_ms']:.3f} ms"
                     if "unpacked_ms" in t else ""))
        if variant == "proxy":
            cap = caps["K2"]
            root = kernel_raw(hw.wave_histogram, cap.kw)(*cap.args)
            print(f"  {label} root pass: largest |g| cell "
                  f"{int(root[..., 0].abs().max())}, largest h cell "
                  f"{int(root[..., 1].max())} quantized units (exact in "
                  f"int32; f32 adds are exact below 2^24 = 16777216)")
        what = ("packed == unpacked launch" if variant == "f32_packed4" else
                "bit-equal to the plain version on the card, two launches "
                "bit-identical" + (", packed == unpacked launch"
                                   if variant.endswith("packed4") else ""))
        print(f"  {label} K2 (root), K1 (first and widest wave): {what}")
    print(f"quantized kernel checks: {time.perf_counter() - t0:.1f} s")

    # 14. card vs CPU on the quantized tier: the LRB parameters at 100,000
    # rows, 20 iterations
    Xc = make_lrb_rows(CPU_ROWS, seed=31)
    yc = lrb_labels(Xc, seed=32)
    params = {**TRAIN_PARAMS, "tpu_quantized_hist": "true",
              "num_iterations": str(CPU_Q_ITERS)}
    cmp_runs = card_and_cpu(params, Xc, yc, CPU_Q_ITERS)
    _, where = judge_trees(cmp_runs, quantized=True)
    print(f"quantized card vs CPU, {CPU_ROWS} LRB rows x {CPU_Q_ITERS} "
          f"iterations (count-proxy): {where}; train auc "
          f"{cmp_runs['cuda'][1]['auc']:.6f} vs "
          f"{cmp_runs['cpu'][1]['auc']:.6f} (within {AUC_TOL}); "
          f"{cmp_runs['cuda'][2]:.1f} s on the card, "
          f"{cmp_runs['cpu'][2]:.1f} s on the CPU")

    entries = []
    src = "lightgbm_tpu_torch/csrc/hist_wave.cu"
    for (kid, variant), t in sorted(out.items()):
        name = ("wave_histogram" if kid == "K2"
                else "fused_partition_histogram") + "_" + variant
        entries.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": ("lightgbm_tpu/ops/hist_wave.py:482" if kid == "K2"
                         else "lightgbm_tpu/ops/hist_wave.py:984"),
            "launches": t["launches"], "max_abs_err": 0.0,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library_note": ("index_add_ of the channels on a flat index "
                             "built beforehand" if kid == "K2" else
                             "no single PyTorch call partitions rows and "
                             "builds their histograms"),
            "shape": t["shape"],
            "launches_per_iteration": t["launches_per_iteration"],
            **({"unpacked_ms": t["unpacked_ms"]} if "unpacked_ms" in t
               else {}),
            **{k: t[k] for k in ("counted_share", "split_ms", "plan")
               if k in t},
            "vs_plain": ("bitwise against the unpacked launch"
                         if variant == "f32_packed4" else
                         "bitwise against the plain version on the card")})
    return entries


def cat_phases(dev, k1_ms_phase7: float, power_limit_w: float) -> list:
    """Phases 15-18 of the module docstring: categorical features.
    ``k1_ms_phase7`` is phase 8's K1 time on phase 7's inputs (no
    categorical rows). Returns the kernels-line entries of K1 with
    categorical rows, f32 and int8."""
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import forest as forest_ops
    from lightgbm_tpu_torch.ops import hist_wave as hw
    from lightgbm_tpu_torch.ops import stacked_predict as sp
    from lightgbm_tpu_torch.utils import log as tlog
    X = make_airline_like(AIRLINE_ROWS, seed=41)
    y = airline_labels(X, seed=42)
    Xt = make_airline_like(HOLDOUT_ROWS, seed=43)
    yt = airline_labels(Xt, seed=44)
    runs = {}

    def train_airline(label, params, cats):
        """train() on the airline rows with ``cats`` categorical,
        capturing the root pass and the widest categorical wave; the
        holdout scored through Booster.predict."""
        lines = []
        tlog.set_callback(lines.append)
        try:
            with capturing() as caps:
                reset_counts()
                t0 = time.perf_counter()
                ds = lgt.Dataset(X, label=y, categorical_feature=cats,
                                 params=params).construct()
                torch.cuda.synchronize()
                bin_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                bst = lgt.train(params, ds, num_boost_round=AIRLINE_ITERS)
                torch.cuda.synchronize()
                train_s = time.perf_counter() - t0
                counts = read_counts()
        finally:
            tlog.set_callback(None)
        torch.cuda.synchronize()
        forest_ops.launches.reset()
        sp.fallbacks.reset()
        prob = bst.predict(Xt)
        torch.cuda.synchronize()
        k4, fallbacks = forest_ops.launches.value, sp.fallbacks.value
        assert k4 > 0 and fallbacks == 0, (label, k4, fallbacks)
        assert prob.shape == (HOLDOUT_ROWS,) and np.isfinite(prob).all()
        auc = auc_np(yt, prob)
        cfg = bst._gbdt._grower_cfg
        iters = bst.current_iteration()
        leaves = [t.num_leaves for t in bst._gbdt.models]
        n_cat = sum(t.num_cat for t in bst._gbdt.models)
        wall, busy = device_busy(bst.update, 2)
        top = host_ops(bst.update, 2)
        cat_waves = caps["K1c"].hits
        print(f"{label}: {AIRLINE_ROWS} x 8 ({len(cats)} categorical), "
              f"{iters} iterations of {leaves} leaves ({n_cat} categorical "
              f"splits), W={cfg.wave_size}, B={cfg.num_bins}, precision "
              f"{cfg.precision}, count-proxy {cfg.count_proxy}; binning "
              f"{bin_s:.2f} s; {1e3 * train_s / iters:.1f} ms/iteration; "
              f"K1 {counts['K1'] / iters:.1f} launches/iteration, "
              f"{cat_waves / iters:.1f} of them with categorical slots; "
              f"holdout auc {auc:.5f} (predict: {k4} forest launches, "
              f"{fallbacks} fallbacks); profile of 2 iterations: wall "
              f"{wall:.1f} ms, device busy {busy:.2f} ms "
              f"({100 * busy / wall:.1f}%); host time per iteration by "
              f"operator: {top}; launches {counts}")
        runs[label] = {"caps": caps, "counts": counts, "iters": iters,
                       "cat_waves": cat_waves, "auc": auc, "cfg": cfg,
                       "lines": lines, "n_cat": n_cat,
                       "mappers": bst._gbdt.train_data.mappers}

    # 15. categorical training at full width, and the same rows numerical
    train_airline("airline categorical", AIRLINE_PARAMS, AIRLINE_CAT_COLUMNS)
    cat = runs["airline categorical"]
    assert cat["cfg"].hp.has_cat and cat["cfg"].precision == "f32"
    assert cat["counts"].get("K1/cat", 0) > 0 and cat["cat_waves"] > 0
    assert cat["n_cat"] > 0
    origin = cat["mappers"][5]          # no column is trivial here
    assert origin.bin_type == 1 and origin.num_bin < AIRLINE_CATEGORIES[5]
    train_airline("airline numerical", AIRLINE_PARAMS, [])
    num = runs.pop("airline numerical")
    assert not num["cfg"].hp.has_cat and "K1/cat" not in num["counts"]
    print(f"  holdout auc: categorical {cat['auc']:.5f}, every column "
          f"numerical {num['auc']:.5f}; Origin: {origin.num_bin} bins for "
          f"{AIRLINE_CATEGORIES[5]} codes (the rest share the last bin)")
    del num

    # 16. the int8 tier: count-proxy asked for, exact counts resolved
    train_airline("airline int8", {**AIRLINE_PARAMS,
                                   "tpu_quantized_hist": True,
                                   "tpu_count_proxy": 1},
                  AIRLINE_CAT_COLUMNS)
    q = runs["airline int8"]
    assert (q["cfg"].precision, q["cfg"].count_proxy) == ("int8", False)
    assert q["cfg"].wave_size <= 40, q["cfg"]
    assert any("tpu_count_proxy needs" in ln and "no categorical features"
               in ln for ln in q["lines"]), q["lines"]
    assert q["counts"].get("K1/int8", 0) > 0 and q["cat_waves"] > 0
    print(f"  int8 tier: W={q['cfg'].wave_size}, the count-proxy warning "
          f"logged; holdout auc {q['auc']:.5f} (exact tier "
          f"{cat['auc']:.5f})")

    # 17. the kernels on those captures
    t0 = time.perf_counter()
    out = []
    for label, variant in (("airline categorical", "f32"),
                           ("airline int8", "int8")):
        caps = runs[label]["caps"]
        assert caps["K1c"].best > 0, f"{label}: no categorical wave"
        k1c = caps["K1c"]
        assert k1c.kw.get("any_cat"), k1c.kw
        if variant == "f32":
            a2, kw2, kw1 = caps["K2"].args, caps["K2"].kw, k1c.kw
            check_histogram(
                f"{label} K2", lambda *a: hw.wave_histogram(*a, **kw2),
                lambda *a, **k: hw.wave_histogram_plain(
                    *a, **plain_kw(kw2), **k),
                a2, lambda o: o, None)
            st = check_histogram(
                f"{label} K1",
                lambda *a: hw.fused_partition_histogram(*a, **kw1),
                lambda *a, **k: hw.fused_partition_histogram_plain(
                    *a, **plain_kw(kw1), **k),
                k1c.args, lambda o: o[1], lambda o: o[0])
        else:
            for key, fn, plain, outs_of in (
                    ("K2", hw.wave_histogram, hw.wave_histogram_plain,
                     lambda o: (o,)),
                    ("K1c", hw.fused_partition_histogram,
                     hw.fused_partition_histogram_plain, tuple)):
                check_int_histogram(f"{label} {key}", fn, plain,
                                    caps[key].args, caps[key].kw, outs_of)
        t = time_histogram("K1", "K1c", caps, dev, label)
        if variant == "f32":
            # the root pass (K2) of the same rows, the pass's other shape
            t["k2_root"] = time_histogram("K2", "K2", caps, dev, label)
            k2r = t["k2_root"]
            print(f"{label} K2 (root) [{k2r['shape']}]: {k2r['ms']:.3f} ms,"
                  f" plain {k2r['plain_ms']:.3f} ms, library "
                  f"{k2r['library_ms']:.3f} ms, bound {k2r['bound_ms']:.4f}"
                  f" ms ({k2r['bound_by']})")
        lib = lib_index_add(caps["K2"].args, dev, caps["K2"].kw)
        # the same launch without its categorical rows (CAT=false, the
        # categorical slots taken as numerical ones)
        a = list(k1c.args)
        a[5] = a[5][:hw.TBL_ROWS_NUM].contiguous()
        no_cat = kernel_raw(hw.fused_partition_histogram,
                            dict(k1c.kw, any_cat=False))
        t["no_cat_ms"] = cuda_ms(lambda: no_cat(*a), 5)
        n_cat = int((k1c.args[5][hw.TBL_ISCAT] != 0).sum())
        it = runs[label]["iters"]
        launches = runs[label]["counts"]["K1/cat"]
        print(f"{label} K1 with categorical rows [{t['shape']}, {n_cat} "
              f"categorical slots]: {t['ms']:.3f} ms, plain "
              f"{t['plain_ms']:.3f} ms, library none ({lib:.3f} ms: "
              f"index_add_ of one pass), bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}); the same launch without its "
              f"categorical rows {t['no_cat_ms']:.3f} ms; "
              f"{launches / it:.2f} launches/iteration;"
              + (f" bit-equal to the plain version in the kernels' order "
                 f"(sums, counts, leaf ids), g/h within "
                 f"{st['max_abs_err_f64']:.3g} of float64"
                 if variant == "f32" else
                 " bit-equal to the plain version on the card")
              + "; two launches bit-identical")
        out.append({
            "name": f"fused_partition_histogram_{variant}_cat",
            "route": "cuda", "source": "lightgbm_tpu_torch/csrc/hist_wave.cu",
            "replaces": "lightgbm_tpu/ops/hist_wave.py:984",
            "launches": launches, "max_abs_err": 0.0,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "index_add_ms": lib,
            "no_cat_ms": t["no_cat_ms"],
            "library_note": ("no single PyTorch call partitions rows and "
                             "builds their histograms; index_add_ms is one "
                             "pass's index_add_ at the root's shape"),
            "shape": t["shape"], "categorical_slots": n_cat,
            **{k: t[k] for k in ("counted_share", "split_ms", "plan",
                                 "k2_root") if k in t},
            "launches_per_iteration": launches / it,
            "categorical_waves_per_iteration": runs[label]["cat_waves"] / it,
            "vs_plain": ("bitwise against the plain version run in the "
                         "kernels' order of addition" if variant == "f32"
                         else "bitwise against the plain version on the "
                         "card")})
    del runs
    gap = k1_ms_phase7 / K1_MS_BEFORE_CAT - 1.0
    if abs(power_limit_w - 700.0) < 1.0:
        assert gap <= 0.10, \
            f"K1 without categorical rows {k1_ms_phase7:.3f} ms vs " \
            f"{K1_MS_BEFORE_CAT} ms"
        verdict = "not more than 10% above it"
    else:
        verdict = f"not held: the card's power limit is {power_limit_w} W"
    print(f"  K1 without categorical rows on phase 7's inputs (phase 8): "
          f"{k1_ms_phase7:.3f} ms, {100 * gap:+.1f}% of the earlier "
          f"{K1_MS_BEFORE_CAT} ms ({verdict})")
    print(f"categorical kernel checks: {time.perf_counter() - t0:.1f} s")
    del X, y, Xt, yt

    # 18. card vs CPU at 100,000 rows of the airline generator
    Xc = make_airline_like(CPU_ROWS, seed=51)
    yc = airline_labels(Xc, seed=52)
    for tier, extra in (("exact", {}),
                        ("int8", {"tpu_quantized_hist": True})):
        cmp_runs = card_and_cpu({**AIRLINE_PARAMS, **extra,
                                 "num_leaves": CAT_CPU_LEAVES}, Xc, yc,
                                CAT_CPU_ITERS,
                                categorical_feature=AIRLINE_CAT_COLUMNS)
        _, where = judge_trees(cmp_runs, quantized=bool(extra))
        n_cat = sum(t.num_cat for t in cmp_runs["cuda"][0]._gbdt.models)
        assert n_cat > 0
        print(f"categorical card vs CPU ({tier} tier), {CPU_ROWS} airline "
              f"rows x {CAT_CPU_ITERS} iterations of {CAT_CPU_LEAVES} "
              f"leaves, {n_cat} categorical "
              f"splits: {where}; train auc "
              f"{cmp_runs['cuda'][1]['auc']:.6f} vs "
              f"{cmp_runs['cpu'][1]['auc']:.6f} (within {AUC_TOL}); "
              f"{cmp_runs['cuda'][2]:.1f} s on the card, "
              f"{cmp_runs['cpu'][2]:.1f} s on the CPU")
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
    power_limit_w = float(smi.split(",")[-1].strip().split()[0])
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

    # 6-9: training on the exact tier; 10-14: the int8 tiers, packed bins
    train, higgs_data = train_phases(dev)
    quant = quant_phases(dev, higgs_data)
    del higgs_data
    # 15-18: categorical features
    k1_ms = next(e["ms"] for e in train
                 if e["name"] == "fused_partition_histogram")
    cat = cat_phases(dev, k1_ms, power_limit_w)

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
    print(json.dumps({"kernels": [forest] + train + quant + cat}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
