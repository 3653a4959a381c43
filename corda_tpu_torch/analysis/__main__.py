"""CLI for the invariant analyzer.

    python -m corda_tpu_torch.analysis corda_tpu_torch/         # human output
    python -m corda_tpu_torch.analysis --json corda_tpu_torch/  # machine output
    python -m corda_tpu_torch.analysis --list-rules             # rule inventory

Exit status: 0 iff the scan is clean (no live findings). ``--json`` prints
one JSON object (Report.as_dict()) so a benchmark and CI can stamp
``analysis_findings`` without parsing human text.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .engine import (DEFAULT_BASELINE, analyze_paths,
                     baseline_entries_from_findings)
from .rules import ALL_RULES


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m corda_tpu_torch.analysis",
        description="AST invariant analyzer for the corda_tpu_torch tree")
    ap.add_argument("paths", nargs="*", default=["corda_tpu_torch"],
                    help="files or directories to scan (default: "
                         "corda_tpu_torch)")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON report object instead of text")
    ap.add_argument("--baseline", default=str(DEFAULT_BASELINE),
                    help="baseline file (default: the checked-in one)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline: every finding is live")
    ap.add_argument("--write-baseline", metavar="REASON",
                    help="write current live findings to the baseline file "
                         "with REASON and exit (bootstrap/refresh helper)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print each rule name and the contract it encodes")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in ALL_RULES:
            print(f"{rule.name}\n    {rule.contract}")
        return 0

    paths = [p for p in args.paths if Path(p).exists()]
    if not paths:
        print("no scannable paths given", file=sys.stderr)
        return 2

    if args.write_baseline:
        report = analyze_paths(paths, use_baseline=False)
        entries = baseline_entries_from_findings(report.findings,
                                                 args.write_baseline)
        Path(args.baseline).write_text(json.dumps(
            {"entries": entries}, indent=2, sort_keys=True) + "\n")
        print(f"wrote {len(entries)} baseline entries -> {args.baseline}")
        return 0

    report = analyze_paths(
        paths,
        baseline_path=None if args.no_baseline else args.baseline,
        use_baseline=not args.no_baseline)

    if args.json:
        print(json.dumps(report.as_dict(), indent=2))
    else:
        for f in report.findings:
            print(f.render())
        print(f"{len(report.findings)} finding(s) · "
              f"{report.checked_files} file(s) · "
              f"{len(report.rules)} rule(s) · "
              f"{len(report.suppressed)} suppressed · "
              f"{len(report.baselined)} baselined")
    return 0 if report.clean else 1


if __name__ == "__main__":
    sys.exit(main())
