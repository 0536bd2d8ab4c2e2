"""Quickstart (PyTorch port): the paper's technique end to end.

1. Build a BERT-base-style encoder (the paper's case study).
2. Run it in conventional row-major (RWMA) and block-wise (BWMA) layout --
   numerically the same function, a layout-only change.
3. Run the hand-written blocked GEMM kernel (on the CPU its plain version).
4. Show the memory-hierarchy consequence on the paper's simulated SoC:
   same math, ~2-3x fewer cycles under BWMA (the trace-driven model, on the
   same device).

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
(the default device is the CUDA card; the kernels build at first use).
"""
import argparse

import torch

from repro_torch.core import encoder as enc
from repro_torch.core import memmodel as mm
from repro_torch.core.layout import BlockLayout, to_blockwise
from repro_torch.kernels.bwma_gemm import bwma_gemm


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = enc.resolve_device(None if args.device == "cuda" else args.device)
    gen = torch.Generator(device=dev).manual_seed(1)

    # --- 1. a (reduced) paper model ---------------------------------------
    cfg = enc.EncoderConfig(seq_len=128, d_model=192, n_heads=3, d_head=64,
                            d_ff=768, n_layers=2, block=16)
    params = enc.init_params(cfg, device=dev)
    x = torch.randn(cfg.seq_len, cfg.d_model, generator=gen, device=dev)

    # --- 2. run both memory arrangements ----------------------------------
    y_rwma = enc.encoder_rwma(params, x, cfg)
    y_bwma = enc.encoder_bwma(enc.block_params(params, cfg, device=dev), x, cfg)
    print("max |BWMA - RWMA| =", float((y_bwma - y_rwma).abs().max()),
          "(layout is purely a memory-system concern)")

    # --- 3. the blocked GEMM kernel ----------------------------------------
    lo = BlockLayout(16, 16)
    a = torch.randn(64, 96, generator=gen, device=dev)
    b = torch.randn(96, 48, generator=gen, device=dev)
    out = bwma_gemm(to_blockwise(a, lo), to_blockwise(b, lo))
    print(f"bwma_gemm on {dev}: {tuple(out.shape)} -- each CTA reads whole "
          "contiguous blocks")

    # --- 4. why it is faster: the paper's measurement ----------------------
    wl = mm.WorkloadConfig(seq=cfg.seq_len, d_model=cfg.d_model,
                           n_heads=cfg.n_heads, d_head=cfg.d_head, d_ff=cfg.d_ff)
    accel = mm.AccelSpec.sa(16)
    r = mm.simulate_layer(wl, accel, "rwma", device=dev)["total"]
    bw_ = mm.simulate_layer(wl, accel, "bwma", device=dev)["total"]
    print(f"simulated SoC (32KB L1 / 1MB L2, SA16x16): "
          f"RWMA {r.cycles:,} cycles vs BWMA {bw_.cycles:,} cycles "
          f"-> {r.cycles / bw_.cycles:.2f}x speedup")
    print(f"L1 misses: {r.l1_misses:,} -> {bw_.l1_misses:,} "
          f"({r.l1_misses / max(bw_.l1_misses, 1):.1f}x fewer)")


if __name__ == "__main__":
    main()
