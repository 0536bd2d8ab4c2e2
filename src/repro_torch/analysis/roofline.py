# repro: noqa-file RPR005 -- CLI report generator: prints ARE the output
"""Roofline analysis over the dry run's records.

Counterpart of ``repro.analysis.roofline``.  Per (arch × shape × mesh) cell
we report three roofline terms, with the H100 SXM's data-sheet constants
(:mod:`repro_torch.analysis.analytic`):

    compute    = FLOPs_global / (GPUs × 989 TFLOP/s dense bf16)
    memory     = HBM_bytes_per_device / 3.35 TB/s
    collective = collective_bytes_per_device / 50 GB/s (NDR InfiniBand)

Term sources -- a deliberate hybrid:

* The **terms** come from the analytic calculator, whose formulas follow
  the sharding rules the port places by.
* The **dry run** (:mod:`repro_torch.launch.dryrun`: rank 0's step run on
  the meta device) is the evidence for (a) the collectives the step
  issues (every one an ``all_reduce`` or a ``broadcast``: count and bytes),
  (b) the per-device bytes (arguments plus the peak of the step's live
  storages: does it fit the card's 80 GB), and (c) the per-device FLOPs
  the step really issues.  Those FLOPs count every layer and microbatch
  (the port runs no scan), so ``useful_ratio`` is 6ND (2ND outside
  training) over the measured global FLOPs, where the JAX report, whose
  XLA counts a loop body once, could only hold 6ND against the analytic
  FLOPs.

No number here is a time measured on a device: the terms are a model.

Usage:
  PYTHONPATH=src python -m repro_torch.analysis.roofline \\
      --dryrun experiments/dryrun_torch --out experiments/roofline_torch.md
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional

import repro_torch.configs as C
from repro_torch.analysis.analytic import MeshInfo, roofline_terms

SHAPE_TOKENS = {  # tokens processed per step (global)
    "train_4k": 4096 * 256,
    "prefill_32k": 32768 * 32,
    "decode_32k": 128,
    "long_500k": 1,
}

HBM_BYTES = 80e9  # spec: H100 SXM 80 GB


def model_flops(rec: Dict) -> float:
    n = rec["active_params"]
    toks = SHAPE_TOKENS[rec["shape"]]
    mult = 6 if rec["shape"] == "train_4k" else 2
    return mult * n * toks


def analyze_record(rec: Dict) -> Optional[Dict]:
    if rec.get("status") != "ok":
        return None
    cfg = C.get_config(rec["arch"])
    mesh = MeshInfo.multi() if rec["mesh"] == "multi" else MeshInfo.single()
    accum = rec.get("accum_steps", 1)
    terms = roofline_terms(cfg, rec["shape"], mesh, accum)
    coll = rec.get("collectives", {})
    mf = model_flops(rec)
    measured = rec["flops"] * rec["n_devices"]
    mem = rec["memory"]
    suggestion = {
        "compute": "cut redundant FLOPs (remat policy, fused kernels, "
                   "lower-precision matmuls)",
        "memory": "reduce HBM traffic: fewer weight re-streams (less accum / "
                  "bigger TP), fused BWMA blocks, fp8 weights",
        "collective": "reshard to cut FSDP gathers (more TP, less ZeRO), "
                      "overlap collectives with compute, int8 grad wire",
    }[terms["dominant"]]
    return {
        **{k: rec[k] for k in ("arch", "shape", "mesh")},
        "gpus": rec["n_devices"],
        "accum": accum,
        "t_compute_s": terms["compute"],
        "t_memory_s": terms["memory"],
        "t_collective_s": terms["collective"],
        "dominant": terms["dominant"],
        "roofline_fraction": terms["roofline_fraction"],
        "roofline_fraction_serial": terms["roofline_fraction_serial"],
        "model_flops_6nd": mf,
        "flops_analytic": terms["flops_global"],
        "useful_ratio": mf / measured if measured else float("nan"),
        "flops_dev": rec["flops"],
        "allreduce_count": coll.get("count", 0),
        "allreduce_bytes": coll.get("all-reduce", 0),
        "broadcast_bytes": coll.get("broadcast", 0),
        "mem_args_gib": mem.get("argument_size_in_bytes", 0) / 2**30,
        "mem_temp_gib": mem.get("temp_size_in_bytes", 0) / 2**30,
        "fits_hbm": (mem.get("argument_size_in_bytes", 0)
                     + mem.get("temp_size_in_bytes", 0)) < HBM_BYTES,
        "suggestion": suggestion,
    }


def load_all(dryrun_dir: str) -> List[Dict]:
    out = []
    for f in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(f) as fh:
            out.append(json.load(fh))
    return out


def markdown_table(rows: List[Dict]) -> str:
    hdr = (
        "| arch | shape | mesh | compute (s) | memory (s) | collective (s) "
        "| dominant | frac (ovl) | frac (serial) | FLOPs/GPU (dry run) "
        "| all-reduces | all-reduce GiB/GPU | GiB/GPU (args+temp) | fits 80G |\n"
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|\n"
    )
    lines = []
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['t_compute_s']:.2e} | {r['t_memory_s']:.2e} "
            f"| {r['t_collective_s']:.2e} | **{r['dominant']}** "
            f"| {r['roofline_fraction']:.3f} | {r['roofline_fraction_serial']:.3f} "
            f"| {r['flops_dev']:.3e} | {r['allreduce_count']} "
            f"| {r['allreduce_bytes'] / 2**30:.2f} "
            f"| {r['mem_args_gib']:.1f}+{r['mem_temp_gib']:.1f} "
            f"| {'y' if r['fits_hbm'] else 'NO'} |"
        )
    return hdr + "\n".join(lines) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", default="experiments/dryrun_torch")
    ap.add_argument("--out", default="experiments/roofline_torch.md")
    ap.add_argument("--mesh", default=None, help="filter: single|multi")
    args = ap.parse_args(argv)
    recs = load_all(args.dryrun)
    rows, skipped = [], []
    for rec in recs:
        if args.mesh and rec.get("mesh") != args.mesh:
            continue
        a = analyze_record(rec)
        if a:
            rows.append(a)
        elif rec.get("status") == "skipped":
            skipped.append(rec)
    rows.sort(key=lambda r: (r["arch"], r["shape"], r["mesh"]))
    md = [
        "# Roofline analysis (H100)\n",
        "\nTerms from the analytic calculator (sharding-rule-exact); the dry-run "
        "columns from rank 0's step on the meta device (no time).  H100 SXM "
        "constants (spec): 989 TF/s dense bf16, 3.35 TB/s HBM3, 50 GB/s per "
        "GPU over NDR InfiniBand, 80 GB HBM.\n",
        f"\n{len(rows)} traced cells, {len(skipped)} documented skips.\n\n",
        markdown_table(rows),
        "\n## Per-cell bottleneck notes\n",
    ]
    for r in rows:
        md.append(
            f"- **{r['arch']} × {r['shape']} × {r['mesh']}** — "
            f"{r['dominant']}-bound (frac {r['roofline_fraction']:.3f}); "
            f"dry run: {r['allreduce_count']} all-reduces "
            f"({r['allreduce_bytes'] / 2**20:.0f} MiB); "
            f"useful ratio {r['useful_ratio']:.3f}; to improve: {r['suggestion']}\n"
        )
    if skipped:
        md.append("\n## Skipped cells\n")
        for s in skipped:
            md.append(f"- {s['arch']} × {s['shape']} × {s['mesh']}: {s['reason']}\n")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write("".join(md))
    print(f"wrote {args.out}: {len(rows)} rows")
    for r in rows:
        print(
            f"{r['arch']:26s} {r['shape']:12s} {r['mesh']:6s} "
            f"dom={r['dominant']:10s} frac={r['roofline_fraction']:.3f} "
            f"serial={r['roofline_fraction_serial']:.3f} "
            f"fits={'y' if r['fits_hbm'] else 'N'}"
        )


if __name__ == "__main__":
    main()
