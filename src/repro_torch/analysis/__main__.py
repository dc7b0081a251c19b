"""CLI driver: ``python -m repro_torch.analysis [paths...]`` (the JAX
package's ``python -m repro.analysis``, over the port's passes and its
baseline ``src/repro_torch/analysis/baseline.json``).

Exit codes: 0 clean (or fully baselined), 1 new findings (or stale
baseline entries under ``--strict-stale``), 2 usage error.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys

from repro_torch.analysis import DEFAULT_BASELINE, ALL_PASSES, analyze_paths
from repro_torch.analysis.findings import (apply_baseline, load_baseline,
                                           write_baseline)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="AST invariant analyzer of the port (locks / "
                    "hostsync / recompile)")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories to analyze (default: "
                         "src/repro_torch)")
    ap.add_argument("--select", action="append", metavar="PASS",
                    choices=sorted(ALL_PASSES),
                    help="run only the named pass (repeatable)")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help=f"allowlist file (default: {DEFAULT_BASELINE} "
                         "when it exists)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignoring any baseline")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write current findings as the new baseline and "
                         "exit 0")
    ap.add_argument("--strict-stale", action="store_true",
                    help="fail when baseline entries no longer occur "
                         "(ratchet tightening)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit findings as JSON on stdout")
    args = ap.parse_args(argv)

    for p in args.paths:
        if not os.path.exists(p):
            print(f"error: no such path: {p}", file=sys.stderr)
            return 2

    passes = set(args.select) if args.select else None
    findings = analyze_paths(args.paths, passes=passes)

    baseline_path = args.baseline
    if baseline_path is None and not args.no_baseline:
        baseline_path = (DEFAULT_BASELINE
                         if os.path.exists(DEFAULT_BASELINE) else None)

    notes: dict = {}
    allowed: collections.Counter = collections.Counter()
    if baseline_path and not args.no_baseline and os.path.exists(
            baseline_path):
        allowed, notes = load_baseline(baseline_path)

    if args.write_baseline:
        out = args.baseline or DEFAULT_BASELINE
        write_baseline(findings, out, notes=notes)
        print(f"wrote {len(findings)} finding(s) to {out}")
        return 0

    new, baselined, stale = apply_baseline(findings, allowed)

    if args.as_json:
        payload = {
            "new": [vars(f) for f in new],
            "baselined": [vars(f) for f in baselined],
            "stale": [{"invariant": k[0], "file": k[1], "scope": k[2],
                       "code": k[3], "count": n}
                      for k, n in sorted(stale.items())],
        }
        json.dump(payload, sys.stdout, indent=2)
        print()
    else:
        for f in new:
            print(f.format("NEW"))
        if stale:
            print(f"note: {sum(stale.values())} stale baseline entr"
                  f"{'y' if sum(stale.values()) == 1 else 'ies'} "
                  "(vetted exceptions that no longer occur — remove "
                  "them with --write-baseline):")
            for k, n in sorted(stale.items()):
                print(f"  {k[1]}: {k[0]} in `{k[2]}` ({n}x): {k[3]}")
        by_pass = collections.Counter(
            f.invariant.split("/")[0] for f in findings)
        summary = ", ".join(f"{p}={n}" for p, n in sorted(by_pass.items()))
        print(f"{len(findings)} finding(s) [{summary or 'none'}]: "
              f"{len(new)} new, {len(baselined)} baselined"
              + (f", {sum(stale.values())} stale" if stale else ""))

    if new:
        return 1
    if stale and args.strict_stale:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
