"""Serving entry point: continuous batching over the block-paged KV cache.

Counterpart of ``python -m repro.launch.serve``, on the CUDA card by
default (``--device cpu`` runs the plain versions of the kernels on the
CPU).  Multi-request workload (Poisson-ish staggered arrivals, fixed seeds):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm-2b --smoke \\
      --num-requests 6 --max-seqs 2 --prompt-len 12 --max-new 16 \\
      --mean-interarrival 4 --page-size 8

``--backend reference`` reads pages through the gather oracle instead of
the paged-decode kernel; ``--engine static|both`` runs the static-wave
baseline.  Without ``--num-requests``, one static wave of ``--batch``
prompts.  The JAX CLI's ``--mesh`` is not ported (ROADMAP.md queue 1 item
26); families other than dense/GQA are refused before anything is
allocated, naming the ROADMAP.md item that ports them.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

import repro_torch.configs as C
from repro_torch.core.encoder import resolve_device
from repro_torch.models import adapters as A
from repro_torch.models import model as M
from repro_torch.serve import (
    Engine,
    EngineConfig,
    ServeConfig,
    Server,
    build_serve_report,
    make_requests,
    run_static_waves,
)
from repro_torch.serve.engine import warn_prefill_chunks_deprecated


def _say(*lines) -> None:
    sys.stdout.write("".join(f"{line}\n" for line in lines))
    sys.stdout.flush()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_single_wave(cfg, params, args, device):
    """One batch, one static wave."""
    srv = Server(cfg, params, ServeConfig(
        max_len=args.prompt_len + args.max_new + 8, temperature=args.temperature,
        seed=args.seed), device=device)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(args.batch, args.prompt_len)).astype(np.int32)
    t0 = time.perf_counter()
    out = srv.generate({"tokens": toks}, max_new_tokens=args.max_new)
    dt = time.perf_counter() - t0
    _say(f"generated {out.shape} tokens in {dt:.2f}s on {device} "
         f"({out.size / dt:.1f} tok/s)", str(out[:, :16]))


def run_workload(cfg, params, args, device):
    """Multi-request workload through the selected engine(s)."""
    reqs = make_requests(
        cfg.vocab_size, args.num_requests,
        prompt_len=args.prompt_len, max_new=args.max_new,
        mean_interarrival=args.mean_interarrival, seed=args.seed,
    )
    max_len = args.prompt_len + args.max_new + 1
    useful = sum(r["max_new_tokens"] for r in reqs)

    if args.engine in ("static", "both"):
        srv = Server(cfg, params, ServeConfig(
            max_len=max_len, temperature=args.temperature, seed=args.seed,
        ), device=device)
        t0 = time.perf_counter()
        outs = run_static_waves(srv, reqs, args.max_seqs)
        _sync(device)
        dt = time.perf_counter() - t0
        _say(f"[static-wave]  {len(outs)} requests, {useful} tokens in "
             f"{dt:.2f}s -> {useful / dt:.1f} tok/s on {device}")

    if args.engine in ("continuous", "both"):
        eng = Engine(cfg, params, EngineConfig(
            max_seqs=args.max_seqs, max_len=max_len,
            page_size=args.page_size, num_pages=args.num_pages,
            temperature=args.temperature, seed=args.seed,
            chunked_prefill=not args.no_chunked_prefill,
            prefill_chunk=args.prefill_chunk,
            prefill_tokens_per_step=args.prefill_tokens_per_step,
            prefill_chunks_per_step=args.prefill_chunks_per_step,
            prefix_sharing=not args.no_prefix_sharing,
            backend=args.backend,
            debug_audit=args.debug_audit,
            obs=args.obs,
        ), device=device)
        for r in reqs:
            eng.submit(r["prompt"], r["max_new_tokens"],
                       rid=r["rid"], arrival_step=r["arrival_step"])
        t0 = time.perf_counter()
        done = eng.run()
        _sync(device)
        dt = time.perf_counter() - t0
        report = build_serve_report(eng, done, wall_s=dt, useful_tokens=useful)
        report["device"] = str(device)
        report["backend"] = args.backend
        print_continuous_report(report)
        if args.json_report:
            with open(args.json_report, "w", encoding="utf-8") as f:
                json.dump(report, f, indent=2)
            _say(f"  json report -> {args.json_report}")
        if args.trace_out:
            trace = eng.export_trace(args.trace_out)
            _say(f"  chrome trace -> {args.trace_out} "
                 f"({len(trace['traceEvents'])} events; open in "
                 f"ui.perfetto.dev or chrome://tracing)")


def print_continuous_report(report):
    """Render the machine-readable serve report as the human table."""
    e, pool, px, wl = (report["engine"], report["pool"],
                       report["prefix_cache"], report["workload"])
    mode = (f"chunked prefill (chunk={e['chunk_size']} tok, "
            f"budget={e['prefill_tokens_per_step']} tok/step)"
            if e["chunked_prefill"] else "one-shot prefill")
    lines = [
        f"[continuous]   {wl['num_requests']} requests, {wl['useful_tokens']} tokens in "
        f"{wl['wall_s']:.2f}s -> {wl['tok_s']:.1f} tok/s on {report['device']} "
        f"(backend {report['backend']}); page={pool['page_size']} "
        f"pool={pool['pages_total'] + 1} cache={pool['cache_mb']:.2f} MB, {mode}",
        "  rid arrive admit queue ttft_ms preempt cached  tok/s  n_tok",
    ]
    for r in report["requests"]:
        tok_s = float("inf") if r["decode_tok_s"] is None else r["decode_tok_s"]
        ttft_ms = float("nan") if r["ttft_ms"] is None else r["ttft_ms"]
        lines.append(
            f"  {r['rid']:3d} {r['arrival_step']:6d} {r['admitted_step']:5d} "
            f"{r['queue_steps']:5d} {ttft_ms:7.1f} {r['preemptions']:7d} "
            f"{r['cached_prompt_tokens']:6d} {tok_s:6.1f} {r['n_tokens']:6d}")
    lines.append(f"  engine steps={e['steps']} decode_steps={e['decode_steps']} "
                 f"prefill_tokens={e['prefill_tokens']} "
                 f"prefill_chunks={e['prefill_chunks']}")
    if px["enabled"]:
        label = (px["mode"] if px["mode"] == "compute-skipping"
                 else "memory-dedup, recompute")
        lines.append(
            f"  prefix cache [{label}]: {px['cached_prompt_tokens']}"
            f"/{px['prompt_tokens']} prompt tokens served from cache "
            f"({100.0 * px['hit_rate']:.1f}% hit rate), "
            f"{pool['pages_aliased_total']} page aliases, "
            f"{pool['cow_copies_total']} COW copies, "
            f"{pool['prefix_cache_pages']} pages resident")
    else:
        lines.append("  prefix cache: off (--no-prefix-sharing)")
    _say(*lines)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=C.arch_ids())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the weights, the page pool and the kernels run")
    ap.add_argument("--batch", type=int, default=4,
                    help="single-wave batch size (--num-requests 0)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--num-requests", type=int, default=0,
                    help="> 0 switches to the multi-request workload path")
    ap.add_argument("--engine", choices=("static", "continuous", "both"),
                    default="continuous")
    ap.add_argument("--max-seqs", type=int, default=4,
                    help="concurrent batch slots (workload path)")
    ap.add_argument("--mean-interarrival", type=float, default=4.0,
                    help="mean request inter-arrival gap in decode steps")
    ap.add_argument("--page-size", type=int, default=0,
                    help="KV page size in tokens; 0 derives from cfg.block")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="physical page pool size; 0 sizes for max_seqs")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked-admission chunk in tokens; 0 derives one page")
    ap.add_argument("--prefill-tokens-per-step", type=int, default=0,
                    help="prompt tokens admitted per engine step before the "
                         "decode batch steps (page-granular); 0 derives from "
                         "the deprecated --prefill-chunks-per-step alias")
    ap.add_argument("--prefill-chunks-per-step", type=int, default=None,
                    help="DEPRECATED alias: admission budget as a chunk count")
    ap.add_argument("--no-chunked-prefill", action="store_true",
                    help="one-shot prefill per admission, installed in place")
    ap.add_argument("--backend", default="cuda", choices=("cuda", "reference"),
                    help="paged-decode path: the paged-attention / paged-copy "
                         "CUDA kernels (their plain versions on the CPU) or "
                         "the gather oracle")
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="disable the shared-prefix page cache")
    ap.add_argument("--obs", action="store_true",
                    help="deep observability: audit-backed pool gauges every "
                         "step + torch.profiler ranges around the decode/chunk "
                         "steps")
    ap.add_argument("--json-report", default="",
                    help="write the latency/prefix-cache report as JSON here")
    ap.add_argument("--trace-out", default="",
                    help="export request-lifecycle spans and engine-step tracks "
                         "as Chrome-trace JSON; validate with "
                         "`python -m repro_torch.serve.obs PATH`")
    ap.add_argument("--debug-audit", action="store_true",
                    help="run the paged-KV refcount auditor after every step")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.prefill_chunks_per_step is not None:
        warn_prefill_chunks_deprecated()
    cfg = C.get_config(args.arch, smoke=args.smoke,
                       dtype=torch.float32 if args.smoke else torch.bfloat16)
    # refuse BEFORE any pool (or even params) is allocated, with the exact
    # family list the adapter registry reports
    msg = A.unsupported_message(cfg)
    if msg is not None:
        raise SystemExit(msg)
    # "cuda" resolves like an entry point's default: it raises without CUDA
    device = resolve_device(None if args.device == "cuda" else args.device)
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(args.seed),
                           device=device)
    if args.num_requests > 0:
        run_workload(cfg, params, args, device)
    else:
        run_single_wave(cfg, params, args, device)


if __name__ == "__main__":
    main()
