# repro: noqa-file RPR005 -- the linter CLI reports findings via print
"""CLI: python -m repro_torch.analysis.staticcheck [paths...]

With no paths it lints the port: ``src/repro_torch``, ``tests/test_torch_*.py``,
``examples/torch_*.py`` and ``chip_smoke.py``, from the current directory
(the repository root).

Exit codes: 0 clean (all findings fixed, pragma'd, or baselined), 1 new
findings, 2 usage error.
"""

from __future__ import annotations

import argparse
import glob
import json
import sys
from pathlib import Path
from typing import List

from . import (
    RULE_DOCS,
    RULE_IDS,
    check_paths,
    format_baseline,
    load_baseline,
    split_by_baseline,
)

DEFAULT_PATHS = (
    "src/repro_torch",
    "tests/test_torch_*.py",
    "examples/torch_*.py",
    "chip_smoke.py",
)
DEFAULT_BASELINE = "staticcheck_torch.baseline"


def expand_paths(paths) -> List[str]:
    """Paths with their glob patterns expanded (a pattern that matches
    nothing stays, so that it is reported as missing)."""
    out: List[str] = []
    for p in paths:
        hits = sorted(glob.glob(p)) if glob.has_magic(p) else []
        out.extend(hits or [p])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.staticcheck",
        description="The port's repo-specific lint pass (rules RPR001-RPR007).",
    )
    ap.add_argument(
        "paths",
        nargs="*",
        default=list(DEFAULT_PATHS),
        help=f"files/directories/globs to lint (default: {' '.join(DEFAULT_PATHS)})",
    )
    ap.add_argument(
        "--select",
        metavar="RULES",
        help="comma-separated rule ids to run (default: all)",
    )
    ap.add_argument(
        "--baseline",
        metavar="FILE",
        default=DEFAULT_BASELINE,
        help=f"baseline file of tolerated findings (default: {DEFAULT_BASELINE})",
    )
    ap.add_argument(
        "--no-baseline",
        action="store_true",
        help="ignore the baseline file; report every finding",
    )
    ap.add_argument(
        "--write-baseline",
        action="store_true",
        help="rewrite the baseline file from the current findings and exit 0",
    )
    ap.add_argument(
        "--list-rules", action="store_true", help="print the rule table and exit"
    )
    ap.add_argument(
        "--format",
        choices=("text", "json"),
        default="text",
        help="output format: human-readable text (default) or a JSON report",
    )
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid in RULE_IDS:
            print(f"{rid}  {RULE_DOCS[rid]}")
        return 0

    rules = None
    if args.select:
        rules = tuple(r.strip() for r in args.select.split(",") if r.strip())
        unknown = set(rules) - set(RULE_IDS)
        if unknown:
            print(f"unknown rule id(s): {sorted(unknown)}", file=sys.stderr)
            return 2

    paths = expand_paths(args.paths)
    missing = [p for p in paths if not Path(p).exists()]
    if missing:
        print(f"no such path(s): {missing}", file=sys.stderr)
        return 2

    try:
        findings = check_paths(paths, rules=rules)
    except ValueError as e:  # malformed pragma
        print(str(e), file=sys.stderr)
        return 2

    baseline_path = Path(args.baseline)
    if args.write_baseline:
        baseline_path.write_text(format_baseline(findings), encoding="utf-8")
        print(f"wrote {len(findings)} finding(s) to {baseline_path}")
        return 0

    baseline = set()
    if not args.no_baseline and baseline_path.is_file():
        baseline = load_baseline(baseline_path)
    new, old = split_by_baseline(findings, baseline)

    if args.format == "json":
        report = {
            "tool": "staticcheck",
            "status": "findings" if new else "clean",
            "n_new": len(new),
            "n_baselined": len(old),
            "findings": [
                {
                    "rule": f.rule,
                    "path": f.path,
                    "line": f.line,
                    "col": f.col,
                    "message": f.message,
                }
                for f in new
            ],
        }
        print(json.dumps(report, indent=2))
        return 1 if new else 0

    for f in new:
        print(f.format())
    n_files = len({f.path for f in new})
    if new:
        print(
            f"\n{len(new)} new finding(s) in {n_files} file(s)"
            + (f" ({len(old)} baselined)" if old else "")
        )
        return 1
    suffix = f" ({len(old)} baselined finding(s))" if old else ""
    print(f"staticcheck: clean{suffix}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
