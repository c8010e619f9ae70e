"""``python -m repro_torch.check`` — run the port's invariant checker suite.

Exit status is 0 when every finding is already in the baseline
(``artifacts/check/baseline_torch.json``, absent while there is nothing to
baseline); new findings exit 1 and print as GitHub ``::error::``
annotations on CI, while baselined ones only warn.

Usage::

    python -m repro_torch.check                        # every pass, card
    python -m repro_torch.check --pass dispatch        # one pass
    python -m repro_torch.check --device cpu           # workloads on host
    python -m repro_torch.check --json findings.json   # machine-readable
    python -m repro_torch.check --write-baseline       # accept findings
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

from repro_torch.check import (PASSES, default_baseline_path, load_baseline,
                               run_pass, split_against_baseline,
                               write_baseline)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.check",
                                 description=__doc__)
    ap.add_argument("--pass", dest="passes", action="append",
                    choices=PASSES, default=None,
                    help="run only this pass (repeatable; default: all)")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="baseline JSON (default: artifacts/check/"
                         "baseline_torch.json at the repo root)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write current findings as the new baseline")
    ap.add_argument("--json", type=Path, default=None,
                    help="also dump findings to this JSON file")
    ap.add_argument("--strict", action="store_true",
                    help="exit non-zero on baselined findings too")
    ap.add_argument("--device", default=None,
                    help="where the dispatch lint's and the sanitizer's "
                         "workloads run (default: the card; 'cpu' asks for "
                         "the host)")
    args = ap.parse_args(argv)

    passes = tuple(args.passes) if args.passes else PASSES
    baseline_path = args.baseline or default_baseline_path()

    findings = []
    for name in passes:
        got = run_pass(name, device=args.device)
        print(f"check[{name}]: {len(got)} finding(s)")
        findings.extend(got)

    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(
            {"passes": list(passes),
             "findings": [f.to_dict() for f in findings]},
            indent=2, sort_keys=True) + "\n")

    if args.write_baseline:
        write_baseline(findings, baseline_path)
        print(f"check: wrote baseline with {len(findings)} finding(s) "
              f"to {baseline_path}")
        return 0

    baseline = load_baseline(baseline_path)
    new, known = split_against_baseline(findings, baseline)

    on_ci = bool(os.environ.get("GITHUB_ACTIONS"))
    warn = "::warning::" if on_ci else "WARNING: "
    err = "::error::" if on_ci else "ERROR: "
    for f in known:
        print(f"{warn}[baselined] {f.pass_name}/{f.rule} at {f.where} "
              f"({f.symbol}): {f.message}")
    for f in new:
        print(f"{err}[NEW] {f.pass_name}/{f.rule} at {f.where} "
              f"({f.symbol}): {f.message}")
    print(f"check: {len(findings)} finding(s) total — {len(new)} new, "
          f"{len(known)} baselined (baseline: {baseline_path})")
    if new:
        print("check: new findings fail the gate; fix them or re-baseline "
              "with --write-baseline after review")
        return 1
    return 1 if (args.strict and known) else 0


if __name__ == "__main__":
    sys.exit(main())
