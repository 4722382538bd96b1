"""Run the port's static-analysis checkers over ``lightgbm_tpu_torch/``
and its scripts at the repo's root: CUDA-graph captures, guarded-by lock
discipline, and the knob, metric and artifact contracts. The checkers
are stdlib only and read the sources as text; nothing they check runs
(``python -m`` imports the package itself first).

Exit codes:
  0  clean (all findings baselined or none)
  1  findings (including STALE baseline entries — the file only
     shrinks toward zero)
  2  usage error (bad arguments, unreadable or forbidden baseline)

Baseline: ``lightgbm_tpu_torch/analysis/baseline.json``, each entry a
finding key and a one-line justification. capture and lock_discipline
findings are refused there: their exemptions live inline next to the
code (``# capture: ok(name) — reason``, ``# unguarded-ok: reason``).

  python -m lightgbm_tpu_torch.analysis                # human-readable
  python -m lightgbm_tpu_torch.analysis --json         # machine-readable
  python -m lightgbm_tpu_torch.analysis --update-baseline
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from . import capture, contracts, lock_discipline
from .core import (BASELINE_PATH, PACKAGE, Baseline, Finding, UsageError,
                   iter_sources)

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_checkers(root: str) -> List[Finding]:
    sources = iter_sources(root)
    info = contracts.build_repo_info(sources, root)
    findings: List[Finding] = []
    findings += capture.check(sources, info.config_fields)
    findings += lock_discipline.check(sources)
    findings += contracts.check(sources, info)
    findings.sort(key=lambda f: (f.path, f.line, f.key))
    return findings


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lightgbm_tpu_torch.analysis",
        description="the port's static analysis (exit 0 clean / "
                    "1 findings / 2 usage error)")
    ap.add_argument("--root", default=_REPO,
                    help="repo root to scan (default: this checkout)")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline JSON (default: {BASELINE_PATH} under "
                         "--root)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable findings on stdout")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from current findings "
                         "(capture/lock_discipline never written; new "
                         "entries get a TODO justification to fill)")
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return 2 if e.code not in (0, None) else 0

    root = os.path.abspath(args.root)
    if not os.path.isdir(os.path.join(root, PACKAGE)):
        print(f"error: {root} does not look like the repo root "
              f"(no {PACKAGE}/ package)", file=sys.stderr)
        return 2
    baseline_path = args.baseline or os.path.join(root, BASELINE_PATH)

    try:
        baseline = Baseline.load(baseline_path)
        findings = run_checkers(root)
    except UsageError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except SyntaxError as e:
        print(f"error: unparsable source: {e}", file=sys.stderr)
        return 2

    if args.update_baseline:
        doc = baseline.dump(findings)
        with open(baseline_path, "w") as fh:
            json.dump(doc, fh, indent=2)
            fh.write("\n")
        print(f"baseline written: {baseline_path} "
              f"({len(doc['entries'])} entries)")
        # report only what the fresh baseline cannot hold
        try:
            baseline = Baseline.load(baseline_path)
        except UsageError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2

    kept, suppressed, stale = baseline.apply(findings)
    stale_findings = [
        Finding("baseline", "stale-entry",
                os.path.relpath(baseline_path, root), 1,
                "baseline entry no longer matches any finding — "
                f"remove it: {k}", k)
        for k in sorted(stale)]
    report = kept + stale_findings

    if args.json:
        print(json.dumps({
            "schema": "lightgbm-tpu-torch/analysis v1",
            "root": root,
            "findings": [f.to_json() for f in report],
            "suppressed_by_baseline": suppressed,
            "stale_baseline_keys": sorted(stale),
            "clean": not report,
        }, indent=2))
    else:
        for f in report:
            print(f.render())
        print(f"analysis: {len(report)} finding(s), "
              f"{suppressed} baselined, {len(stale)} stale baseline "
              f"entr{'y' if len(stale) == 1 else 'ies'}")
    return 1 if report else 0


if __name__ == "__main__":
    sys.exit(main())
