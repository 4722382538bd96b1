"""Times the feature and data learners across 2 ranks sharing one GPU,
with their busy share and their top host and device operators.

    python3 learner_probe.py [--pkg DIR] [--tag NAME]

The ranks (``lightgbm_tpu_torch.parallel.elastic.run_world``, gloo on
cuda:0) train chip_smoke.py's phase 30 window (1,000,000 x 53,
``TRAIN_PARAMS``) for 10 iterations under ``tree_learner=feature``, then
``data``. After each run every rank trains 5 more iterations (timed
between synchronizations), 2 under torch.profiler's CUDA activity (the
card's busy milliseconds, ``chip_smoke.device_busy``) and 2 more under
the CPU and CUDA profiler (the operators with the most self device time
and self host time an iteration). ``--pkg`` names the directory holding
the ``lightgbm_tpu_torch`` and ``chip_smoke.py`` to time (default: beside
this script), so that two versions can be compared in one call, each in
processes of their own: run it for the parent, the change, the change
and the parent. Rank 0's readings are printed, a line a run; exits
non-zero without a card or when a rank fails.
"""
import argparse
import os
import sys
import tempfile
import time

RUNS = [{"name": "feature", "params": {"tree_learner": "feature"}},
        {"name": "data_f32", "params": {"tree_learner": "data"}}]
TOP = 10


def hook(booster, run, spec, rank):
    """After a run, in each rank: the readings of the module docstring."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        booster.train_one_iter()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 5
    wall, busy = chip_smoke.device_busy(lambda: booster.train_one_iter(), 2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            booster.train_one_iter()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    dev = sorted([e for e in ka if e.self_device_time_total > 0],
                 key=lambda e: -e.self_device_time_total)[:TOP]
    host = sorted(ka, key=lambda e: -e.self_cpu_time_total)[:TOP]
    return {"ms_5": ms, "busy": [wall, busy],
            "device_top": [(e.key[:60], e.self_device_time_total / 2e3,
                            e.count // 2) for e in dev],
            "host_top": [(e.key[:60], e.self_cpu_time_total / 2e3,
                          e.count // 2) for e in host]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pkg", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("learner_probe: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.pkg)
    sys.path.insert(0, root)
    import chip_smoke
    from lightgbm_tpu_torch.parallel import elastic
    from lightgbm_tpu_torch.utils import cuda_build
    cuda_build.build_all()
    params = {**chip_smoke.TRAIN_PARAMS, "num_iterations": "10"}
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        # the ranks import this module for the hook, and the package
        # and chip_smoke.py from their own directory, ``--pkg``
        out = elastic.run_world(tmp, {
            "maker": "chip_smoke:dist_window", "device": "cuda:0",
            "params": params, "runs": RUNS, "hook": "learner_probe:hook"},
            2, env={"OMP_NUM_THREADS": "4", "PYTHONPATH": here},
            timeout_s=300)
    if any(out["codes"]):
        print(f"learner_probe: ranks exited {out['codes']}\n{out['logs']}",
              file=sys.stderr)
        return 1
    for r in out["results"][0]["runs"]:
        print(f"{args.tag} {r['name']}: {r['ms_per_iter_after_first']:.1f} "
              f"ms an iteration after the first, {r['ms_5']:.1f} over 5 "
              f"more; busy {r['busy'][1]:.1f} of {r['busy'][0]:.1f} ms over "
              f"2; collectives {r['collective_ms_per_iter']:.1f} ms, "
              f"{r['collective_calls_per_iter']:.0f} calls an iteration")
        print("  device (ms, calls an iteration):",
              [(k, round(v, 3), c) for k, v, c in r["device_top"]])
        print("  host (ms, calls an iteration):",
              [(k, round(v, 3), c) for k, v, c in r["host_top"]])
    return 0


if __name__ == "__main__":
    sys.exit(main())
