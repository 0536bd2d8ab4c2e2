# repro: noqa-file RPR005 -- the CLI: the findings prints ARE the output
"""CLI: ``python -m repro_torch.analysis.torchcheck``.

Traces the serving engine's hot-path step inventory and runs the RPJ rules
against the runs.  Exit 0 when clean (modulo the checked-in
``torchcheck.budgets``), 1 on findings, 2 on usage errors.  Runs on the
card unless ``--device cpu`` asks for the CPU, where the kernel-route
steps (``decode_step``, ``cow_copy``) are left out and named.

  # check the tree against the checked-in budgets, on the card
  PYTHONPATH=src python -m repro_torch.analysis.torchcheck

  # the same on the CPU (kernel steps left out)
  PYTHONPATH=src python -m repro_torch.analysis.torchcheck --device cpu

  # re-baseline after an intentional memory/gather change (steps not
  # traced here keep their sections)
  PYTHONPATH=src python -m repro_torch.analysis.torchcheck --write-budgets

  # CI report artifact
  PYTHONPATH=src python -m repro_torch.analysis.torchcheck --json-out torchcheck.json
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis.torchcheck import (
    RULE_DOCS,
    RULE_IDS,
    Budgets,
    format_budgets,
    load_budgets,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.torchcheck",
        description="static analysis over the engine's hot-path steps, traced",
    )
    ap.add_argument("--arch", default="minicpm-2b",
                    help="model config to trace the inventory at")
    ap.add_argument("--max-seqs", type=int, default=2)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--backend", default="cuda",
                    choices=("reference", "cuda"),
                    help="decode/COW route the primary decode_step and "
                         "cow_copy specs run (default: cuda, the kernels)")
    ap.add_argument("--mesh", default="",
                    help="DxM mesh spec (e.g. 1x2): trace the SHARDED "
                         "inventory as rank 0 of a fake process group and "
                         "gate RPJ106 collective budgets")
    ap.add_argument("--budgets", default=None,
                    help="budgets/waivers file (default: ./torchcheck.budgets, "
                         "or ./torchcheck_mesh.budgets under --mesh)")
    ap.add_argument("--write-budgets", action="store_true",
                    help="measure and (re)write the budgets file, keep waivers")
    ap.add_argument("--select", nargs="+", choices=RULE_IDS, default=None,
                    help="run only these rules")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--json-out", default=None,
                    help="write a JSON report")
    ap.add_argument("--device", default=None,
                    help="where the steps run (default: the card; cpu leaves "
                         "out the kernel-route steps)")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid in RULE_IDS:
            print(f"{rid}  {RULE_DOCS[rid]}")
        return 0

    # mesh budgets live in their own file: a rank's sizes (and collectives)
    # are a different baseline than the single-device ones
    budgets_path = Path(args.budgets or (
        "torchcheck_mesh.budgets" if args.mesh else "torchcheck.budgets"
    ))
    budgets = Budgets()
    if budgets_path.exists():
        try:
            budgets = load_budgets(budgets_path)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    elif not args.write_budgets:
        print(f"note: {budgets_path} not found — RPJ102/RPJ105 will report "
              f"unbudgeted steps; run --write-budgets to baseline",
              file=sys.stderr)

    from repro_torch.analysis.torchcheck.harness import measure, trace
    from repro_torch.analysis.torchcheck.inventory import InventoryConfig, serving_inventory
    from repro_torch.analysis.torchcheck.rules import run_rules

    geometry = InventoryConfig(
        arch=args.arch, max_seqs=args.max_seqs, max_len=args.max_len,
        page_size=args.page_size, backend=args.backend, mesh=args.mesh,
        device=args.device,
    )
    with serving_inventory(geometry) as inv:
        steps = [trace(spec) for spec in inv.specs]
        measured = {ts.name: measure(ts) for ts in steps}
        if args.write_budgets:
            # a step left out here (the kernel route on the CPU) keeps the
            # section another device measured
            kept = {name: dict(budgets.steps[name]) for name in inv.left_out
                    if name in budgets.steps}
            budgets_path.write_text(format_budgets(
                {**kept, **measured}, tolerance=budgets.tolerance,
                allowed_widest=budgets.allowed_widest, waivers=budgets.waivers,
                reasons=budgets.reasons, conversions=budgets.conversions,
            ), encoding="utf-8")
            print(f"wrote {budgets_path} ({len(measured)} steps measured, "
                  f"{len(kept)} kept)")
            return 0
        findings = run_rules(steps, inv, budgets, select=args.select)
        left_out = dict(inv.left_out)
        device = str(inv.device)
        chunk_size, closure = inv.chunk_size, list(inv.chunk_closure)
    for f in findings:
        print(f.format())
    for name, why in left_out.items():
        print(f"{name}: left out on {device}: {why}")

    if args.json_out:
        report = {
            "tool": "torchcheck",
            "arch": args.arch,
            "device": device,
            "geometry": {
                "max_seqs": args.max_seqs, "max_len": args.max_len,
                "page_size": args.page_size, "backend": args.backend,
                "mesh": args.mesh,
            },
            "chunk_size": chunk_size,
            "chunk_closure": closure,
            "n_steps": len(steps),
            "steps": measured,
            "left_out": left_out,
            "launches": {ts.name: ts.launches for ts in steps},
            "waivers": {step: budgets.reasons.get(step, {}) for step in budgets.waivers},
            "allowed_conversions": {
                step: {f"{a}->{b}": why for (a, b), why in pairs.items()}
                for step, pairs in budgets.conversions.items()},
            "findings": [f.to_json() for f in findings],
            "status": "findings" if findings else "clean",
        }
        Path(args.json_out).write_text(
            json.dumps(report, indent=2) + "\n", encoding="utf-8"
        )

    n = len(findings)
    print(f"torchcheck: {len(steps)} traced steps on {device}, "
          f"{len(left_out)} left out, {n} finding{'s' if n != 1 else ''}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
