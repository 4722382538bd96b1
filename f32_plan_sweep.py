"""Times the f32 histogram pass (K1, K2) at five main-path shapes under
each slot-part count the plan may take, on one GPU.

    python3 f32_plan_sweep.py [--pkg DIR] [--parts 1,2,4] [--check]
                              [--out sweep.json]

The shapes are chip_smoke.py's f32 launches: the HIGGS shape's widest
wave (K1, 11,000,000 x 28, W=32, B=64) and root pass (K2, W=1), the LRB
window's wave (K1, 1,000,000 x 52, W=15, B=256), the airline shape's
wave with a categorical slot (K1, 10,000,000 x 8, W=32, B=256) and K2
over the one-hot airline set's bundle columns (10,000,000 x 11, W=24,
B=255). The inputs are synthetic, made on the card from a seed: uniform
bins, normal g, uniform h, leaf ids spread so that about the main
path's share of rows is counted; so the times are of these inputs, not
of the main path's. ``--pkg`` names the directory holding the
``lightgbm_tpu_torch`` to time (default: beside this script), so that
two versions can be timed in one call, each in a process of its own.
Each shape is timed with the plan ``hist_wave.hist_plan`` picks and,
where the package has slot parts (``_group_plan_for``), with the best
plan of each count in ``--parts``: per launch over 20 launches between
CUDA events, with the slot / histogram / reduce split
(``hist_wave.pass_times``) and the plan on this card. ``--check`` also
holds each shape's launches, at 300,000 rows and at W=64 with B=256,
bit for bit against the plain version in the kernels' order. Prints one
line a reading and a last ``RESULT`` line of JSON; exits non-zero
without a card or when a launch disagrees.
"""
import argparse
import json
import os
import sys

SHAPES = {  # name: (kernel, rows, features, slots, bins, leaf ids, cat)
    "HIGGS K1": ("K1", 11_000_000, 28, 32, 64, 64, False),
    "HIGGS K2 W=1": ("K2", 11_000_000, 28, 1, 64, 1, False),
    "LRB K1": ("K1", 1_000_000, 52, 15, 256, 80, False),
    "airline cat K1": ("K1", 10_000_000, 8, 32, 256, 48, True),
    "K2 bundles": ("K2", 10_000_000, 11, 24, 255, 160, False),
}
CHECK_ROWS = 300_000
CHECK_EXTRA = {"W64 B256 K1": ("K1", CHECK_ROWS, 5, 64, 256, 128, False),
               "W64 B256 K2": ("K2", CHECK_ROWS, 3, 64, 256, 70, False)}
RUNS = 20


def inputs(hw, torch, kind, n, F, W, B, leaf_hi, any_cat, seed, dev):
    """A K1 or K2 launch's arguments: uniform bins, normal g, uniform h
    (zero where out of bag), leaf ids in [0, leaf_hi) and, for K1, a
    split table over the W slots (leaves 0..W-1), every other slot's
    right child counted, slot 0 categorical when ``any_cat``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    bins = torch.randint(0, B, (F, n), generator=gen, device=dev,
                         dtype=torch.int32).to(torch.uint8)
    g = torch.randn(n, generator=gen, device=dev)
    h = torch.rand(n, generator=gen, device=dev) * 0.25
    leaf = torch.randint(0, leaf_hi, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    if kind == "K2":
        wl = torch.arange(W, dtype=torch.int32, device=dev)
        return (bins, g, h, leaf, wl, B), {}
    mask = (torch.rand(n, generator=gen, device=dev) < 0.8).float()
    tbl = torch.zeros((hw.TBL_ROWS if any_cat else hw.TBL_ROWS_NUM, W),
                      dtype=torch.int32)
    wl = torch.arange(W, dtype=torch.int32)
    tbl[hw.TBL_PARENT] = wl
    tbl[hw.TBL_NEW] = wl + leaf_hi
    tbl[hw.TBL_FEAT] = wl % F
    tbl[hw.TBL_BIN] = B // 3
    tbl[hw.TBL_DLEFT] = 1
    tbl[hw.TBL_NUMBIN] = B
    tbl[hw.TBL_SMALL] = torch.where(wl % 2 == 0, wl + leaf_hi, wl)
    if any_cat:
        tbl[hw.TBL_ISCAT, 0] = 1
        tbl[hw.TBL_CATW:hw.TBL_ROWS, 0] = 0x5555
    return (bins, g * mask, h * mask, mask, leaf, tbl.to(dev), B), \
        {"any_cat": any_cat}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pkg", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--parts", default="1,2,4")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--out", default="")
    a = ap.parse_args()
    pkg = os.path.abspath(a.pkg)
    sys.path.insert(0, pkg)
    import torch
    if not torch.cuda.is_available():
        print("f32_plan_sweep: no CUDA device", file=sys.stderr)
        sys.exit(1)
    import lightgbm_tpu_torch
    from lightgbm_tpu_torch.ops import hist_wave as hw
    assert os.path.abspath(lightgbm_tpu_torch.__file__).startswith(pkg)
    dev = torch.device("cuda:0")
    own = hw._group_plan
    split_parts = hasattr(hw, "_group_plan_for")
    out = {"pkg": pkg, "readings": {}}
    todo = [(name, None) for name in SHAPES]
    if split_parts:
        todo += [(name, int(p)) for name in SHAPES
                 for p in a.parts.split(",")]
    for name, parts in todo:
        kind, n, F, W, B, hi, cat = SHAPES[name]
        if parts is not None:
            if parts > W or hw._group_plan_for(F, W, B, parts) is None:
                continue
            hw._group_plan = (lambda S: lambda F_, W_, B_:
                              hw._group_plan_for(F_, W_, B_, S)[1])(parts)
        else:
            hw._group_plan = own
        hw.hist_plan.cache_clear()
        args, kw = inputs(hw, torch, kind, n, F, W, B, hi, cat, 0, dev)
        fn = hw.wave_histogram if kind == "K2" else \
            hw.fused_partition_histogram
        for _ in range(3):
            fn(*args, **kw)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(RUNS):
            fn(*args, **kw)
        e1.record()
        torch.cuda.synchronize()
        lp = hw.launch_plan(n, F, W, B, False, dev)
        key = name if parts is None else f"{name}, {parts} slot parts"
        out["readings"][key] = {
            "ms": e0.elapsed_time(e1) / RUNS,
            "split_ms": hw.pass_times(lambda: fn(*args, **kw), 10),
            "plan": {k: lp.get(k) for k in (
                "fg", "classes", "slot_parts", "warps", "blocks_per_sm",
                "grid", "ranges", "rows_per_range", "smem")}}
        print(key, json.dumps(out["readings"][key]), flush=True)
        del args
        torch.cuda.empty_cache()
    hw._group_plan = own
    hw.hist_plan.cache_clear()
    bad = []
    if a.check:
        for name, (kind, n, F, W, B, hi, cat) in {**SHAPES,
                                                  **CHECK_EXTRA}.items():
            n = min(n, CHECK_ROWS)
            args, kw = inputs(hw, torch, kind, n, F, W, B, hi, cat, 5, dev)
            fn, plain = ((hw.wave_histogram, hw.wave_histogram_plain)
                         if kind == "K2" else
                         (hw.fused_partition_histogram,
                          hw.fused_partition_histogram_plain))
            got = [fn(*args, **kw) for _ in "ab"]
            want = hw.plain_in_kernel_order(plain, *args, **kw)
            if kind == "K2":
                got, want = [(x,) for x in got], (want,)
            eq = all(torch.equal(x, y) for x, y in zip(got[0], want)) and \
                all(torch.equal(x, y) for x, y in zip(got[0], got[1]))
            print(f"check {name}: bit-equal {eq}, plan "
                  f"{hw.hist_plan(n, F, W, B)._asdict()}", flush=True)
            if not eq:
                bad.append(name)
        out["check_failed"] = bad
    print("RESULT " + json.dumps(out))
    if a.out:
        with open(a.out, "w") as fh:
            json.dump(out, fh, indent=1)
    if bad:
        sys.exit(1)


if __name__ == "__main__":
    main()
