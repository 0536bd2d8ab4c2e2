"""Reproduce the paper's headline figures on the simulated SoC (PyTorch port).

Prints the Fig. 6a / 6b / 7 / 8 quantities and the §3.2 conversion cost for
the full BERT-base layer, with the trace-driven memory model on the CUDA
card (seconds; the SA8x8 RWMA trace is 127 M cache lines).

Run:  PYTHONPATH=src python examples/torch_bwma_layer_comparison.py \\
          [--device cpu] [--fast]
(``--fast``: a reduced layer, seconds on the CPU too.)
"""
import argparse

from repro_torch.core import memmodel as mm
from repro_torch.core.encoder import resolve_device

CLOCK_HZ = 2.3e9  # the simulated SoC's CPU clock (paper §4.1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--fast", action="store_true",
                    help="reduced workload (seconds on the CPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(None if args.device == "cuda" else args.device)
    wl = (mm.WorkloadConfig(seq=128, d_model=192, n_heads=3, d_head=64, d_ff=768)
          if args.fast else mm.WorkloadConfig())
    print(f"workload: BERT layer seq={wl.seq} d={wl.d_model} "
          f"heads={wl.n_heads} ff={wl.d_ff}, model on {dev}")
    ms = 1e3 / CLOCK_HZ
    print("Fig. 6a (single core):")
    for accel in mm.PAPER_ACCELERATORS:
        r = mm.simulate_layer(wl, accel, "rwma", device=dev)["total"]
        b = mm.simulate_layer(wl, accel, "bwma", device=dev)["total"]
        print(f"  {accel.name:8s}  RWMA {r.cycles * ms:8.1f} ms   "
              f"BWMA {b.cycles * ms:8.1f} ms   speedup {r.cycles / b.cycles:.2f}x"
              f"   L1-miss ratio {r.l1_misses / max(b.l1_misses, 1):.1f}x")
    accel = mm.AccelSpec.sa(16)
    print("Fig. 6b (SA16x16, cores):")
    for cores in (1, 2, 4):
        r = mm.simulate_layer(wl, accel, "rwma", cores, device=dev)["total"].cycles
        b = mm.simulate_layer(wl, accel, "bwma", cores, device=dev)["total"].cycles
        print(f"  cores={cores}  RWMA {r * ms:8.1f} ms  BWMA {b * ms:8.1f} ms  "
              f"speedup {r / b:.2f}x")
    print("Fig. 7 (SA16x16, share of the layer's cycles):")
    res = {layout: mm.simulate_layer(wl, accel, layout, device=dev)
           for layout in ("rwma", "bwma")}
    for layout, comps in res.items():
        gemm = sum(comps[c].cycles for c in mm.GEMM_COMPONENTS) / comps["total"].cycles
        print(f"  {layout}: GEMM {100 * gemm:5.1f} %  non-GEMM {100 * (1 - gemm):5.1f} %")
    print("Fig. 8 (SA16x16, RWMA / BWMA):")
    for field in ("l1_misses", "l2_accesses", "dram_accesses", "addr_cycles"):
        a, b = getattr(res["rwma"]["total"], field), getattr(res["bwma"]["total"], field)
        print(f"  {field:14s} {a:>14,} / {b:>14,} = {a / max(b, 1):.2f}x")
    frac = mm.conversion_overhead_fraction(wl, accel, device=dev)
    print(f"§3.2 RWMA<->BWMA conversion: {100 * frac:.3f} % of a 12-layer model")


if __name__ == "__main__":
    main()
