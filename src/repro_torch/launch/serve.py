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
prompts.  Served: dense and MoE stacks (granite-moe-3b-a800m, DeepSeek-V3)
over paged GQA K/V, sliding-window GQA rings (h2o-danube-3-4b), MLA latent
pages, SSM state rows (mamba2-130m), hybrid ring + state rows (hymba-1.5b)
and enc-dec cross rows (whisper-tiny), e.g. on the card in bf16:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-3b-a800m \
      --num-requests 8 --prompt-len 512 --max-new 64

An audio config (whisper-tiny) gives every request its own (1,
encoder_seq, d_model) audio embedding, drawn from ``--seed``; the JAX
CLI's stub of zeros stands in only where a caller gives none.  A vision
config (qwen2-vl-72b) runs on the static ``Server`` with the JAX CLI's
stubs (zero image rows over the prompt's first ``n_frontend_tokens``
tokens, ``arange`` on all three M-RoPE streams; ``--prompt-len`` at least
1024 at full width):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-72b \
      --batch 4 --prompt-len 1280 --max-new 64

its multi-request workload takes ``--engine static``: the continuous
engine has no cache adapter for it and refuses it before anything is
allocated, as the JAX CLI does.

``--mesh DxM`` serves over ``D*M`` ranks, as the JAX serve mode places
the weights: each rank keeps its share of every weight, resident and split
over both axes (its attention heads' columns, its share of the FFN width or
its experts, a vocab slice of the embedding and the head), and the KV pools
of its model slice of heads (replicated over the data axis); the ranks sum
their shares with ``all_reduce``.  Each rank draws only its own shares from
``--seed`` (the same numbers as the run without a mesh), so no rank ever
holds the full tree: its peak while loading is its shares plus one full
leaf or one layer.  Started alone, the CLI spawns its ``D*M`` ranks (gloo
on the CPU or where the ranks share a card, NCCL where each rank has a card
of its own); under ``torchrun --nproc-per-node D*M`` it joins the group
torchrun set up.  Rank 0 alone prints:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm-2b --smoke \
      --device cpu --num-requests 6 --max-seqs 2 --mesh 2x2
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
      --arch starcoder2-7b --num-requests 8 --prompt-len 512 --mesh 1x2
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

import repro_torch.configs as C
from repro_torch.core.encoder import resolve_device
from repro_torch.distributed import sharding as SH
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


_QUIET = False  # ranks other than 0 of a mesh print nothing
# --mesh: a collective that waits longer than this fails the run
DIST_TIMEOUT_S = 300


def _say(*lines) -> None:
    if _QUIET:
        return
    sys.stdout.write("".join(f"{line}\n" for line in lines))
    sys.stdout.flush()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def audio_extras(cfg, n: int, seed: int):
    """``n`` per-request audio inputs, each a (1, encoder_seq, d_model)
    standard-normal ``audio_embeds`` from a numpy seed; None for a config
    without an audio frontend."""
    if cfg.frontend != "audio":
        return [None] * n
    rng = np.random.default_rng([seed, 1])
    return [{"audio_embeds": rng.standard_normal((1, cfg.encoder_seq, cfg.d_model),
                                                 dtype=np.float32)} for _ in range(n)]


def run_single_wave(cfg, params, args, device, mesh=None):
    """One batch, one static wave (``Server.generate`` fills a vision
    config's stubs, as the JAX CLI does)."""
    srv = Server(cfg, params, ServeConfig(
        max_len=args.prompt_len + args.max_new + 8, temperature=args.temperature,
        seed=args.seed), mesh=mesh, device=device)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(args.batch, args.prompt_len)).astype(np.int32)
    batch = {"tokens": toks}
    extras = audio_extras(cfg, args.batch, args.seed)
    if extras[0] is not None:
        batch["audio_embeds"] = np.concatenate([e["audio_embeds"] for e in extras])
    t0 = time.perf_counter()
    out = srv.generate(batch, max_new_tokens=args.max_new)
    dt = time.perf_counter() - t0
    _say(f"generated {out.shape} tokens in {dt:.2f}s on {device} "
         f"({out.size / dt:.1f} tok/s)", str(out[:, :16]))


def run_workload(cfg, params, args, device, mesh=None):
    """Multi-request workload through the selected engine(s)."""
    reqs = make_requests(
        cfg.vocab_size, args.num_requests,
        prompt_len=args.prompt_len, max_new=args.max_new,
        mean_interarrival=args.mean_interarrival, seed=args.seed,
    )
    for r, extras in zip(reqs, audio_extras(cfg, len(reqs), args.seed)):
        r["extras"] = extras
    max_len = args.prompt_len + args.max_new + 1
    useful = sum(r["max_new_tokens"] for r in reqs)

    if args.engine in ("static", "both"):
        srv = Server(cfg, params, ServeConfig(
            max_len=max_len, temperature=args.temperature, seed=args.seed,
        ), mesh=mesh, device=device)
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
        ), mesh=mesh, device=device)
        for r in reqs:
            eng.submit(r["prompt"], r["max_new_tokens"],
                       rid=r["rid"], arrival_step=r["arrival_step"], extras=r["extras"])
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
        lines.append("  prefix cache: off (--no-prefix-sharing, or caches that are not "
                     "shared: SWA rings, SSM states, audio side inputs, MoE under "
                     "one-shot prefill)")
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
    ap.add_argument("--mesh", default="",
                    help="DxM mesh (e.g. 2x2): serve over D*M ranks -- the weights "
                         "resident and split over both axes, each rank drawing its "
                         "own shares, KV pools head-sharded over the model axis, "
                         "all_reduce sums.  Spawns the ranks unless started under "
                         "torchrun")
    return ap


def _backend(device_type: str, world: int) -> str:
    """NCCL where each rank has a card of its own; gloo on the CPU and for
    ranks that share a card (NCCL refuses two ranks on one device)."""
    if device_type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def _rank_device(args, rank: int) -> torch.device:
    if args.device == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def serve(args, device: torch.device, mesh=None) -> None:
    """Build the config and weights and run the selected path, on ``mesh``
    if one is given (every rank runs this with the same arguments)."""
    cfg = C.get_config(args.arch, smoke=args.smoke,
                       dtype=torch.float32 if args.smoke else torch.bfloat16)
    kinds = "+".join(f"{n} {kind}" for kind, n in A.layer_segments(cfg))
    caches = ("static (no cache adapter)" if A.unsupported_reason(cfg)
              else ", ".join(ad.family for ad in A.all_adapters(cfg)))
    _say(f"serving {cfg.name} ({kinds} layers; caches: {caches}) on {device}")
    layout = None
    if mesh is not None:
        shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
        _say(f"serving on mesh {args.mesh}: {shape['data']} data x {shape['model']} model")
        layout = SH.ServeLayout(cfg, mesh)
    # the weights from the seed, on the device (the numbers of the run
    # without a mesh); under a mesh each rank draws its own shares
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(args.seed),
                           device=device, layout=layout)
    if layout is not None:
        mine, whole = layout.nbytes(params)
        _say(f"weights drawn by shards: {mine / 2**20:.1f} MiB a rank of "
             f"{whole / 2**20:.1f} MiB")
    if args.num_requests > 0:
        run_workload(cfg, params, args, device, mesh)
    else:
        run_single_wave(cfg, params, args, device, mesh)


def _run_rank(rank: int, args, world: int, store: str) -> None:
    """One rank of ``--mesh``: join the group (a file store, or torchrun's
    environment when ``store`` is empty), serve, leave."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_serve_mesh

    global _QUIET
    _QUIET = rank != 0
    device = _rank_device(args, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    timeout = datetime.timedelta(seconds=DIST_TIMEOUT_S)
    kw = ({"store": dist.FileStore(store, world), "rank": rank, "world_size": world}
          if store else {})
    dist.init_process_group(_backend(device.type, world), timeout=timeout, **kw)
    try:
        serve(args, device, make_serve_mesh(args.mesh))
    finally:
        dist.destroy_process_group()


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.prefill_chunks_per_step is not None:
        warn_prefill_chunks_deprecated()
    cfg = C.get_config(args.arch, smoke=args.smoke)
    if args.num_requests > 0 and args.engine != "static":
        # refuse BEFORE any pool (or even params) is allocated, with the
        # exact family list the adapter registry reports
        msg = A.unsupported_message(cfg, hint="rerun with --engine static")
        if msg is not None:
            raise SystemExit(msg)
    # "cuda" resolves like an entry point's default: it raises without CUDA
    device = resolve_device(None if args.device == "cuda" else args.device)
    if not args.mesh:
        serve(args, device)
        return
    from repro_torch.launch.mesh import parse_mesh

    d, m = parse_mesh(args.mesh)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # under torchrun
        _run_rank(int(os.environ["RANK"]), args, int(os.environ["WORLD_SIZE"]), "")
        return
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_run_rank, args=(args, d * m, os.path.join(tmp, "store")),
                           nprocs=d * m, start_method="spawn")


if __name__ == "__main__":
    main()
