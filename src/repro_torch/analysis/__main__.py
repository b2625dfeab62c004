"""``python -m repro_torch.analysis`` — the reprolint CLI.

Exit codes: 0 clean (or every finding baselined/suppressed), 1 when new
findings exist (or, with ``--fail-on-stale``, when baseline entries no
longer fire — the shrink ratchet), 2 on usage errors.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List

from .engine import run_checks
from .findings import dump_baseline

# the port's own baseline name: the JAX package's ``reprolint_baseline.json``
# is keyed by that package's paths and is never read by default
DEFAULT_BASELINE = "reprolint_torch_baseline.json"


def main(argv: List[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="reprolint: check the repo's parity/RNG/purge contracts",
    )
    ap.add_argument("paths", nargs="+", help="files or directories to scan")
    ap.add_argument(
        "--baseline",
        default=None,
        help=f"baseline JSON of grandfathered findings (default: "
        f"./{DEFAULT_BASELINE} when present)",
    )
    ap.add_argument(
        "--no-baseline",
        action="store_true",
        help="ignore any baseline file; every finding counts as new",
    )
    ap.add_argument(
        "--write-baseline",
        metavar="FILE",
        default=None,
        help="write the current finding set as the new baseline and exit 0",
    )
    ap.add_argument(
        "--report",
        metavar="FILE",
        default=None,
        help="write the machine-readable JSON report (REPROLINT_report.json)",
    )
    ap.add_argument(
        "--format",
        choices=("text", "json"),
        default="text",
        help="stdout format (default text: path:line:col rule-id message)",
    )
    ap.add_argument(
        "--fail-on-stale",
        action="store_true",
        help="also fail when baseline entries no longer fire (they must be "
        "deleted — the baseline only shrinks)",
    )
    args = ap.parse_args(argv)

    baseline = args.baseline
    if baseline is None and not args.no_baseline and os.path.exists(DEFAULT_BASELINE):
        baseline = DEFAULT_BASELINE
    if args.no_baseline:
        baseline = None

    try:
        report = run_checks(args.paths, baseline_path=baseline)
    except (OSError, SyntaxError, ValueError) as e:
        print(f"reprolint: error: {e}", file=sys.stderr)
        return 2

    if args.write_baseline:
        dump_baseline(args.write_baseline, report.findings)
        print(
            f"reprolint: wrote {len(report.findings)} finding(s) to "
            f"{args.write_baseline}"
        )
        return 0

    if args.report:
        with open(args.report, "w", encoding="utf-8") as f:
            json.dump(report.to_dict(), f, indent=2)
            f.write("\n")

    if args.format == "json":
        json.dump(report.to_dict(), sys.stdout, indent=2)
        print()
    else:
        for f in report.new:
            print(f.format())
        for f in report.baselined:
            print(f"{f.format()} [baselined]")
        for p, r, s in report.stale_baseline:
            print(f"reprolint: stale baseline entry {p} {r} {s} — delete it")
        print(
            f"reprolint: {report.files_scanned} files, "
            f"{len(report.new)} new, {len(report.baselined)} baselined, "
            f"{len(report.suppressed)} suppressed, "
            f"{len(report.stale_baseline)} stale"
        )

    if report.new:
        return 1
    if args.fail_on_stale and report.stale_baseline:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
