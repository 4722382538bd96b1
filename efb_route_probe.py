"""Float64 probe of phase 25's two f32 routes on the one-hot airline
rows (ROADMAP queue 3 O and P), on one card.

    python3 efb_route_probe.py

Trains tree 0 of ``chip_smoke.py`` phase 25's data on the bundled route
(a) and on the unbundled K1 route (b, ``enable_bundle=false``,
``tpu_sparse=0``, (a)'s wave width), finds the splits the two trees share
(the same feature and threshold at the same path from the root), and
for every leaf at the frontier of those splits sums the histograms of
all 674 features in float64 from the port's f32 g and h of iteration 0.
For each frontier position where the routes' choices differ it prints
one JSON line: the rows, the five best splits by exact gain, and each
route's split with its f32 gain and its exact gain.
"""
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke as cs  # noqa: E402


def main():
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.utils import cuda_build
    dev = torch.device("cuda:0")
    import subprocess
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    cuda_build.build_all()
    X = cs.make_airline_like(cs.AIRLINE_ROWS, seed=41)
    y = cs.airline_labels(X, seed=42)
    csr = cs.one_hot_airline(X)
    t0 = time.time()
    ds_a = lgt.Dataset(csr, label=y, params=cs.AIRLINE_PARAMS).construct()
    bst_a = lgt.train(cs.AIRLINE_PARAMS, ds_a, num_boost_round=1)
    cfg_a = bst_a._gbdt._grower_cfg
    text_a = bst_a.model_to_string()
    del bst_a, ds_a
    torch.cuda.empty_cache()
    flat = {**cs.AIRLINE_PARAMS, "enable_bundle": False, "tpu_sparse": 0,
            "tpu_wave_size": cfg_a.wave_size}
    ds_b = lgt.Dataset(csr, label=y, params=flat).construct()
    # route (b)'s first K2 (the root) and first two K1 launches, their
    # outputs against float64 sums of the same rows (see ``check_hist``)
    from lightgbm_tpu_torch.ops import wave_grower as wg
    seen = {"K2": [], "K1": []}
    k2_fn, k1_fn = wg.wave_histogram, wg.fused_partition_histogram

    def k2_spy(bins_t, g, h, leaf_ids, wl, *a, **kw):
        out = k2_fn(bins_t, g, h, leaf_ids, wl, *a, **kw)
        if not seen["K2"]:
            seen["K2"].append((g.clone(), h.clone(), leaf_ids.clone(),
                               wl.clone(), out.clone()))
        return out

    def k1_spy(bins_t, g, h, mask, leaf_ids, tbl, *a, **kw):
        out = k1_fn(bins_t, g, h, mask, leaf_ids, tbl, *a, **kw)
        if len(seen["K1"]) < 2:
            seen["K1"].append((g.clone(), h.clone(), mask.clone(),
                               out[0].clone(), tbl.clone(), out[1].clone()))
        return out
    wg.wave_histogram, wg.fused_partition_histogram = k2_spy, k1_spy
    try:
        bst_b = lgt.train(flat, ds_b, num_boost_round=1)
    finally:
        wg.wave_histogram, wg.fused_partition_histogram = k2_fn, k1_fn
    text_b = bst_b.model_to_string()
    print(f"trained both routes in {time.time() - t0:.1f} s", flush=True)
    ta = lgt.Booster(model_str=text_a)._gbdt.models[0]
    tb = lgt.Booster(model_str=text_b)._gbdt.models[0]
    inner = bst_b._gbdt.train_data
    meta = inner.feature_meta()
    bins = inner.bins_t                      # [674, N] member bins
    assert inner.bundles is None and bins.shape[0] == csr.shape[1]
    print("missing types", np.unique(np.asarray(meta.missing_type)),
          "num_bin max", int(np.asarray(meta.num_bin).max()), flush=True)

    for t in (ta, tb):
        print("tree 0 splits:", [(int(t.split_feature[i]),
                                  float(t.threshold[i]),
                                  float(t.split_gain[i])) for i in range(20)])

    # each tree's internal nodes by their path from the root
    def by_path(t):
        out = {}

        def walk(node, path):
            if node >= 0:
                out[path] = node
                walk(int(t.left_child[node]), path + "L")
                walk(int(t.right_child[node]), path + "R")
        walk(0, "")
        return out
    pa, pb = by_path(ta), by_path(tb)
    common = {p for p in pa if p in pb
              and (ta.split_feature[pa[p]], ta.threshold[pa[p]])
              == (tb.split_feature[pb[p]], tb.threshold[pb[p]])}
    # keep only the common splits whose ancestors are all common
    common = {p for p in common
              if all(p[:k] in common for k in range(len(p)))}
    paths = sorted({p + c for p in common for c in "LR"} - common,
                   key=lambda q: (len(q), q))
    print(f"{len(common)} common splits; frontier {paths}")
    path_id = {p: k for k, p in enumerate(paths)}
    n = bins.shape[1]
    mappers = inner.mappers

    def thr_bin(j, thr):
        m = mappers[inner.real_to_inner[j]]
        return int(np.searchsorted(m.bin_upper_bound[:m.num_searched()],
                                   thr, side="left"))
    # each row's frontier leaf: walk the common splits on the member
    # bins (a bin at or below the threshold's goes left)
    leaf = torch.full((n,), -1, dtype=torch.int64, device=dev)
    cur = {"": torch.ones(n, dtype=torch.bool, device=dev)}
    for p in sorted(common, key=len):
        sel = cur.pop(p)
        node = pa[p]
        j = int(ta.split_feature[node])
        left = bins[inner.real_to_inner[j]].to(torch.int64) <= thr_bin(
            j, float(ta.threshold[node]))
        for c, m in (("L", sel & left), ("R", sel & ~left)):
            if p + c in common:
                cur[p + c] = m
            else:
                leaf[m] = path_id[p + c]
    assert not cur and bool((leaf >= 0).all())
    L = len(paths)
    counts = torch.bincount(leaf, minlength=L).cpu().numpy()
    print("frontier leaves:", {p: int(counts[path_id[p]]) for p in paths})
    fa = {p: pa.get(p, -1) for p in paths}
    fb = {p: pb.get(p, -1) for p in paths}

    # g and h of iteration 0 as the port computes them (f32), summed in
    # float64
    from lightgbm_tpu_torch.objectives import create_objective
    from lightgbm_tpu_torch.config import Config
    cfg = Config().set({k: str(v) for k, v in flat.items()})
    obj = create_objective("binary", cfg)
    obj.init(inner.metadata, n)
    s0 = obj.boost_from_score(0)
    score = torch.full((n,), float(np.float32(s0)), dtype=torch.float32,
                       device=dev)
    g, h = obj.get_gradients(score)
    g64, h64 = g.double(), h.double()
    B = int(np.asarray(meta.num_bin).max())
    F = bins.shape[0]
    hg = torch.zeros((F, L, B), dtype=torch.float64, device=dev)
    hh = torch.zeros_like(hg)
    hc = torch.zeros_like(hg)
    for f in range(F):
        idx = leaf * B + bins[f].to(torch.int64)
        hg[f] = torch.bincount(idx, weights=g64, minlength=L * B).view(L, B)
        hh[f] = torch.bincount(idx, weights=h64, minlength=L * B).view(L, B)
        hc[f] = torch.bincount(idx, minlength=L * B).view(L, B).double()
    G = hg[0].sum(1)
    H = hh[0].sum(1)
    N = hc[0].sum(1)
    # exact gains, MISSING_NONE: right = bins > t, t <= nb - 2
    nb = torch.as_tensor(np.asarray(meta.num_bin), device=dev)
    mt = np.asarray(meta.missing_type)
    assert (mt == 0).all(), "the float64 search covers MISSING_NONE only"
    rg = hg.flip(-1).cumsum(-1).flip(-1)      # sum over bins >= b
    rh = hh.flip(-1).cumsum(-1).flip(-1)
    rcn = hc.flip(-1).cumsum(-1).flip(-1)
    # right of threshold t = bins >= t + 1
    rg = torch.cat([rg[..., 1:], torch.zeros_like(rg[..., :1])], -1)
    rh = torch.cat([rh[..., 1:], torch.zeros_like(rh[..., :1])], -1)
    rcn = torch.cat([rcn[..., 1:], torch.zeros_like(rcn[..., :1])], -1)
    lg, lh, lcn = G[None, :, None] - rg, H[None, :, None] - rh, \
        N[None, :, None] - rcn
    gain = lg ** 2 / lh + rg ** 2 / rh - (G ** 2 / H)[None, :, None]
    t_idx = torch.arange(B, device=dev)
    ok = ((t_idx[None, None, :] <= (nb - 2)[:, None, None])
          & (lcn >= 20) & (rcn >= 20) & (lh >= 1e-3) & (rh >= 1e-3))
    gain = torch.where(ok, gain, float("-inf"))
    flatg = gain.permute(1, 0, 2).reshape(L, -1)
    best = flatg.max(1)
    rows = []
    for p in paths:
        k = path_id[p]
        bf, bt = divmod(int(best.indices[k]), B)
        top = torch.topk(flatg[k], 5)
        entry = {"path": p, "rows": int(counts[k]),
                 "exact_top5": [(int(inner.used_feature_map[i // B]),
                                 int(i % B), float(v)) for v, i in zip(
                     top.values.cpu().tolist(), top.indices.cpu().tolist())],
                 "G": float(G[k]), "H": float(H[k])}
        for name, t, fr in (("a", ta, fa), ("b", tb, fb)):
            node = fr[p]
            if node < 0 or t.left_child is None:
                entry[name] = "leaf"
                continue
            j = int(t.split_feature[node])
            tbn = thr_bin(j, float(t.threshold[node]))
            entry[name] = {"node": node, "feature": j, "threshold_bin": tbn,
                           "f32_gain": float(t.split_gain[node]),
                           "exact_gain": float(gain[inner.real_to_inner[j],
                                                    k, tbn])}
        rows.append(entry)

        def key(e):
            return e if e == "leaf" else (e["feature"], e["threshold_bin"])
        if key(entry["a"]) != key(entry["b"]):
            print(json.dumps(entry), flush=True)
    check_hist(bins, seen)
    print(f"{len(rows)} frontier positions, "
          f"{sum(1 for e in rows if e['a'] == 'leaf' and e['b'] == 'leaf')}"
          " leaves in both trees")
    print(smi)


def check_hist(bins, seen) -> None:
    """Route (b)'s root K2 histogram and its first two K1 launches'
    smaller-child histograms [W, F, B, 3] against the float64 sums of the
    same rows' f32 g, h and counts: per launch the largest absolute
    difference of each channel, the largest float64 sum, and the bins
    where the difference exceeds 1e-3 of that cell's sum of |g| plus one
    (an f32 sum of at most 10,000,000 terms rounds far below that)."""
    from lightgbm_tpu_torch.ops import hist_wave as hw
    F, n = bins.shape
    for name, recs in seen.items():
        for r in recs:
            if name == "K2":
                g, h, ids, wl, hist = r
                slot_ids, count = wl.to(torch.int64), ids >= 0
            else:
                g, h, mask, ids, tbl, hist = r
                slot_ids = tbl[hw.TBL_SMALL].to(torch.int64)
                count = mask > 0
            W, _, B, C = hist.shape
            # each row's slot: the slot whose (smaller) child holds it
            slot = torch.full((n,), -1, dtype=torch.int64, device=bins.device)
            for w in range(W):
                if int(slot_ids[w]) >= 0:
                    slot[(ids.to(torch.int64) == slot_ids[w]) & count] = w
            keep = slot >= 0
            ref = torch.zeros((W, F, B, 3), dtype=torch.float64,
                              device=bins.device)
            absg = torch.zeros((W, F, B), dtype=torch.float64,
                               device=bins.device)
            for f in range(F):
                idx = slot[keep] * B + bins[f][keep].to(torch.int64)
                for c, v in enumerate((g[keep].double(), h[keep].double(),
                                       None)):
                    wts = v if v is not None else None
                    ref[:, f, :, c] = torch.bincount(
                        idx, weights=wts, minlength=W * B).view(W, B)
                absg[:, f] = torch.bincount(
                    idx, weights=g[keep].double().abs(),
                    minlength=W * B).view(W, B)
            d = (hist[..., :3].double() - ref).abs()
            bad = d[..., 0] > 1e-3 * absg + 1.0
            print(json.dumps({
                "launch": name, "W": W, "rows": int(keep.sum()),
                "max_abs_diff": [float(d[..., c].max()) for c in range(3)],
                "max_abs_sum": [float(ref[..., c].abs().max())
                                for c in range(3)],
                "bad_cells": int(bad.sum()),
                "bad_features": sorted({int(x) for x in
                                        torch.nonzero(bad)[:, 1].tolist()})[:20],
                "bad_slots": sorted({int(x) for x in
                                     torch.nonzero(bad)[:, 0].tolist()})}),
                  flush=True)


if __name__ == "__main__":
    main()
