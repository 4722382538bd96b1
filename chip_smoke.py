"""Smoke run of the PyTorch/CUDA port (lightgbm_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the forest kernel from csrc/forest_predict.cu, then drives the
port's scoring path through the entry points a user calls:

1. device: needs CUDA; prints the card's name and power limit;
2. build: nvcc's time and register report;
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
   calls, each checked against the plain version.

Prints a JSON line of the kernels, then the last line
``{"ok": true, "device": {...}}``. Any failed check raises, and the
script exits non-zero without that line. The model generators are
importable (the body runs only under ``__main__``).
"""
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

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")

    # 2. build
    path, secs, report = forest_ops.build_library()
    print(f"build: {secs:.2f} s -> {os.path.relpath(path, ROOT)}")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

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

    # 6. kernels line
    print(json.dumps({"kernels": [{
        "name": "forest_predict", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/forest_predict.cu",
        "replaces": "lightgbm_tpu/ops/stacked_predict.py:1048",
        "launches": launches, "max_abs_err": max_abs_err,
        "vs_plain": "bitwise", "ms": higgs["ms"],
        "plain_ms": higgs["plain_ms"], "bound_ms": higgs["bound_ms"],
        "bound_by": higgs["bound_by"], "library_ms": None,
        "rows": higgs["rows"], "serve_launches": serve_launches,
        "lrb": {k: lrb[k] for k in ("rows", "ms", "plain_ms", "bound_ms",
                                    "bound_by")}}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
