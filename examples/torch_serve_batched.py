"""Serving example (PyTorch port): per-family caches + continuous batching.

Part 1 shows the per-family cache behaviour of the static-wave server:
  * minicpm (dense MHA)      -- full KV cache,
  * h2o-danube (SWA)         -- O(window) ring buffer,
  * mamba2 (SSM)             -- O(1) state,
  * hymba (hybrid)           -- ring + state.

Part 2 runs the same dense model through the continuous-batching engine:
requests arrive staggered, are admitted when the block-paged KV cache has
pages free, and a finished request's slot is re-filled the same step.  On
the card its paged decode runs the hand-written paged-attention kernel.

Run:  PYTHONPATH=src python examples/torch_serve_batched.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

import repro_torch.configs as C
from repro_torch import tree as T
from repro_torch.core.encoder import resolve_device
from repro_torch.models import model as M
from repro_torch.serve import Engine, EngineConfig, ServeConfig, Server, make_requests


def demo(arch: str, device, max_new=24):
    cfg = C.get_config(arch, smoke=True, dtype=torch.float32)
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    srv = Server(cfg, params, ServeConfig(max_len=96, temperature=0.7, seed=1), device=device)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 12)).astype(np.int32)
    cache = M.init_cache(cfg, 4, 96, device="meta")
    cache_bytes = sum(x.numel() * x.element_size() for x in T.leaves(cache))
    t0 = time.time()
    out = srv.generate({"tokens": toks}, max_new_tokens=max_new)
    dt = time.time() - t0
    print(f"{arch:24s} cache={cache_bytes / 1e6:7.2f} MB  "
          f"{out.shape[0]}x{out.shape[1]} tokens in {dt:5.2f}s")
    return out


def demo_continuous(arch: str, device, num_requests=6):
    cfg = C.get_config(arch, smoke=True, dtype=torch.float32)
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    eng = Engine(cfg, params, EngineConfig(max_seqs=2, max_len=40, page_size=8),
                 device=device)
    for r in make_requests(cfg.vocab_size, num_requests, prompt_len=12,
                           max_new=16, mean_interarrival=4.0):
        eng.submit(r["prompt"], r["max_new_tokens"],
                   rid=r["rid"], arrival_step=r["arrival_step"])
    t0 = time.time()
    done = eng.run()
    dt = time.time() - t0
    n_tok = sum(len(r.out_tokens) for r in done)
    print(f"{arch:24s} {num_requests} requests / 2 slots, "
          f"page={eng.kv.page_size} cache={eng.kv.cache_bytes() / 1e6:.2f} MB: "
          f"{n_tok} tokens in {dt:.2f}s ({eng.decode_steps} decode steps)")
    for r in done:
        print(f"   rid {r.rid}: arrived step {r.stats.arrival_step:2d}, "
              f"queued {r.stats.queue_steps} steps, "
              f"{len(r.out_tokens)} tokens, "
              f"first 6: {np.asarray(r.out_tokens[:6])}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    device = resolve_device(None if args.device == "cuda" else args.device)
    print("batched generation (4 sequences), per cache family:")
    for arch in ("minicpm-2b", "h2o-danube-3-4b", "mamba2-130m", "hymba-1.5b"):
        demo(arch, device)
    print("\ncontinuous batching over the block-paged KV cache:")
    demo_continuous("minicpm-2b", device)


if __name__ == "__main__":
    main()
