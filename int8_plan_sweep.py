"""Times every plan of the int8 histogram pass on the main path's int8
launches, against the plan ``hist_wave.int_plan`` picks, on one GPU.

    python3 int8_plan_sweep.py [--out sweep.json]

Trains 1 or 2 iterations of chip_smoke.py's int8 shapes (the HIGGS
shape on the count-proxy tier, unpacked and packed; the LRB window on
the int8 tier with exact counts; the airline shape with categorical
columns), capturing each one's root pass (K2q) and its widest wave
(K1q; for the airline shape the widest wave with a categorical slot),
as chip_smoke.py does. For each capture it launches K1q or K2q through
its wrapper under every plan that fits an SM (features per group, slot
classes, copies of each cell: ``hist_wave.int_plans``), and under
int_plan's choice in each other kernel instance (4 or 8 bin byte rows;
the registers of 1 or 2 blocks an SM), each through
``hist_wave.use_int_plan``; holds each one's outputs equal to int_plan's
launch (which equals the plain version, checked too), and times each
over 5 launches between CUDA events. Prints, per capture, int_plan's
choice and time, the fastest plans and the instances; writes every
reading to ``--out`` as JSON. Exits non-zero without a card or when any
launch disagrees.
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


def sweep(kid, cap, cs, hw):
    """Every fitting plan of one captured K2q or K1q launch, and every
    other kernel instance of int_plan's choice."""
    import torch
    a, kw = cap.args, cap.kw
    bins_t, B = a[0], a[-1]
    F = kw.get("num_features") or bins_t.shape[0]
    n = bins_t.shape[1]
    W = a[4].shape[0] if kid == "K2" else a[5].shape[1]
    C = 2 if kw.get("count_proxy") else 3
    packed = bool(kw.get("packed4"))
    fn = hw.wave_histogram if kid == "K2" else hw.fused_partition_histogram
    plain = (hw.wave_histogram_plain if kid == "K2"
             else hw.fused_partition_histogram_plain)
    raw = cs.kernel_raw(fn, kw)

    def outs(o):
        return o if isinstance(o, tuple) else (o,)
    want = outs(raw(*a))
    same = all(torch.equal(x, y) for x, y in
               zip(want, outs(plain(*a, **cs.plain_kw(kw)))))
    chosen = hw.int_plan(n, F, W, B, C, packed)
    rec = {"kid": kid, "shape": dict(F=F, n=n, W=W, B=B, C=C, packed=packed),
           "equal_plain": same, "plan": chosen._asdict(),
           "plan_ms": cs.cuda_ms(lambda: raw(*a), 5), "plans": [],
           "instances": []}

    def timed(**choice):
        with hw.use_int_plan(**choice):
            ok = all(torch.equal(x, y) for x, y in zip(outs(raw(*a)), want))
            return ok, cs.cuda_ms(lambda: raw(*a), 5)
    for p in hw.int_plans(n, F, W, B, C, packed):
        ok, ms = timed(fg=p.fg, classes=p.classes, copies=p.copies)
        rec["plans"].append(dict(fg=p.fg, classes=p.classes, copies=p.copies,
                                 units=p.units, byte_rows=p.byte_rows,
                                 blocks=p.blocks, equal=ok, ms=ms))
    need = -(-chosen.fg // 2) if packed else chosen.fg
    for rows in (hw.INT_BYTE_ROWS // 2, hw.INT_BYTE_ROWS):
        for blocks in range(1, chosen.blocks + 1):
            if rows < need:
                continue
            ok, ms = timed(fg=chosen.fg, classes=chosen.classes,
                           copies=chosen.copies, byte_rows=rows,
                           blocks=blocks)
            rec["instances"].append(dict(
                byte_rows=rows, blocks=blocks, equal=ok, ms=ms,
                chosen=(rows, blocks) == (chosen.byte_rows, chosen.blocks)))
    return rec


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        print("int8_plan_sweep: no CUDA device", file=sys.stderr)
        sys.exit(1)
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    out_path = ap.parse_args().out
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import hist_wave as hw
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    X, y = cs.make_higgs_like(cs.HIGGS_TRAIN_ROWS)
    Xl = cs.make_lrb_rows(cs.LRB_TRAIN_ROWS, seed=21)
    Xa = cs.make_airline_like(cs.AIRLINE_ROWS, seed=41)
    lrb = {**cs.TRAIN_PARAMS, "tpu_quantized_hist": "true",
           "tpu_count_proxy": "0"}
    lrb.pop("num_iterations")
    runs = (
        ("higgs proxy", X, y, {**cs.HIGGS_PARAMS,
                               "tpu_quantized_hist": True}, None, 1, "K1w"),
        ("higgs packed proxy", X, y,
         {**cs.HIGGS_PARAMS, "tpu_quantized_hist": True,
          "max_bin": cs.PACKED_MAX_BIN}, None, 1, "K1w"),
        ("lrb int8", Xl, cs.lrb_labels(Xl, seed=22), lrb, None, 2, "K1w"),
        ("airline int8", Xa, cs.airline_labels(Xa, seed=42),
         {**cs.AIRLINE_PARAMS, "tpu_quantized_hist": True},
         cs.AIRLINE_CAT_COLUMNS, 1, "K1c"))
    records, bad = [], 0
    for label, Xr, yr, params, cats, iters, k1 in runs:
        with cs.capturing() as caps:
            ds = lgt.Dataset(Xr, label=yr, categorical_feature=cats or "auto",
                             params=dict(params)).construct()
            lgt.train(dict(params), ds, num_boost_round=iters)
        torch.cuda.synchronize()
        for kid, key in (("K2", "K2"), ("K1", k1)):
            rec = dict(sweep(kid, caps[key], cs, hw), label=label)
            records.append(rec)
            plans = sorted(rec["plans"], key=lambda r: r["ms"])
            bad += (not rec["equal_plain"]) + sum(
                not r["equal"] for r in plans + rec["instances"])
            p = rec["plan"]
            print(f"{label} {kid} {rec['shape']}: int_plan Fg {p['fg']}, "
                  f"{p['classes']} classes, {p['copies']} copies, "
                  f"{p['byte_rows']} byte rows, {p['blocks']} blocks/SM, "
                  f"{rec['plan_ms']:.4f} ms; {len(plans)} plans, fastest: "
                  + "; ".join(f"Fg {r['fg']} K {r['classes']} copies "
                              f"{r['copies']} ({r['blocks']}/SM) "
                              f"{r['ms']:.4f}" for r in plans[:5]))
            print("  its instances: " + "; ".join(
                f"{r['byte_rows']} byte rows, {r['blocks']}/SM "
                f"{r['ms']:.4f}{' (chosen)' if r['chosen'] else ''}"
                for r in rec["instances"]))
        del caps, ds
    if out_path:
        with open(out_path, "w") as fh:
            json.dump(records, fh)
    assert bad == 0, f"{bad} launches differ"
    print("every plan's launch equal to int_plan's and to the plain version")


if __name__ == "__main__":
    main()
