#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

Run from the repository root on a machine with an H100 (sm_90a) and nvcc:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  -- require CUDA; the card's name and power limit (nvidia-smi).
2. build   -- compile the CUDA kernels from ``src/repro_torch/kernels/csrc``.
3. kernels -- each kernel against its plain PyTorch version on the card, at
   the shapes one BERT-base encoder layer gives it (blocks 16 and 128, batch
   4) and at a ragged shape; timed with CUDA events beside the plain version,
   one PyTorch library call for the same function (a yardstick only; the port
   never calls it) and the least time the card could take (H100 SXM spec);
   each GEMM case also prints its CTA tile, its share of the fp32 peak and
   every CTA tile that spans its blocks, each held and timed alike.  Then
   bwma_attention alone at BERT-base shapes, blocks 16 and 128, batches 4
   and 1, with SDPA as its yardstick, its bound and its share of the fp32
   peak (over the padded width and over the logical d_head) and the plan's
   CTA tile (BQ, BKV), and in bf16 (within one bf16 rounding of its plain
   version).  Then bwma_layernorm alone at BERT-base shapes, blocks 16 and
   128, batches 4 and 1, in fp32 and bf16, with F.layer_norm as its
   yardstick, its bound and its plan.  Every
   timed kernel row here and in phases 5 and 7 also gives the kernel's own
   device time per launch from torch.profiler (``device_ms``; the event
   time of a kernel of a few microseconds is mostly the wrapper's Python),
   the library call's (``library_device_ms``) and the wrapper's host time
   per call with no synchronise between calls (``host_us``).
4. encoder -- the 12-layer BERT-base encoder, blocks 16 and 128, on a batch
   of 4 sequences of 512 and on one unbatched sequence, through the
   ``"cuda"`` backend, held against the ``"reference"`` backend and
   ``encoder_rwma``; the kernels' launch counts per forward must be exactly
   60 bwma_gemm, 12 bwma_fused_ffn, 24 bwma_layernorm, 12 bwma_attention;
   the forward is timed and profiled (device time by kernel, idle share;
   no kernel of the port's CUDA sources may be filed under "other").
5. serving kernels -- rwma_gemm at BERT-base projection shapes (blocks 16
   and 128, beside bwma_gemm at equal tiling: the paper's comparison) and
   at the starcoder2-7b products of the rwma serving run (tiles 128, 16
   and 24), each GEMM row with its CTA tile, share of the fp32 peak and
   tile sweep as in phase 3, and at tile 9 over 45 columns (the
   general-tile route), paged_attention_decode at starcoder2-7b decode shapes (fp32 and bf16
   pools, ragged positions, a scattered page table with unmapped entries on
   the null page; each slot's output also bit-identical alone, behind
   null-page columns and run to run; the row gives the split's keys and its
   working CTAs, and its device time is the split and combine kernels'
   together) and paged_copy (bit-exact), each against its plain
   version, timed beside its bound and one library call.  Then ``dense`` in
   bf16 on the bwma and rwma routes at a starcoder2-7b product, against the
   xla route at 2e-2 (one launch each, a bf16 result).
6. serve -- starcoder2-7b at full width (32 layers, d_model 4608, 36 heads
   over 4 kv heads, vocab 49152; random weights drawn on the card from a
   seed) through the continuous-batching ``Engine`` with the ``"cuda"``
   backend: 8 requests of 100-1500 prompt tokens, one the 700-token prefix
   of another (its tail page is shared, so copy-on-write fires), 64 new
   tokens each, 4 slots, pages and chunks of 128.  Gates, in fp32: greedy
   tokens equal the single-request ``Server.generate`` except where the
   baseline's top-2 logit margin is below 1e-3 at the first divergence;
   paged_attention_decode launches == 32 x decode steps; paged_copy launches
   == 2 x COW copies >= 2; a clean pool audit; a ``"reference"`` engine run
   launches no paged kernel; a 4-layer ``gemm_backend="rwma"`` run launches
   rwma_gemm and agrees with the xla route under the same margin rule.
   Timed in bf16 (the config's type): decode step ms (median, p90), decode
   tokens/s, TTFT, the device time by kernel of one profiled decode step and
   the device's idle share.
7. mla kernels -- mla_paged_attention_decode at DeepSeek-V3 decode shapes
   (B=4, 128 heads, latent 512, rope 64, pages of 128, seq_pos
   0/127/1000/1900, a scattered page table with unmapped entries on the null
   page; fp32 and bf16 pools), bwma_softmax at BERT-base attention-score
   shapes (4 x 12 heads of 512 x 512, blocks 16 and 128, a full and a ragged
   logical width, fp32 and bf16; each row with its plan: rows per CTA,
   vectors per lane, looped, CTAs) and at looped widths (2176 fp32 and 4224
   bf16 padded columns), and bwma_transpose at BERT-base K shapes (512 x 64
   per head, blocks 16 and 128, fp32 and bf16, bit-exact; each row with its
   plan: word, tile, CTAs), each against its plain version, timed (in both
   types) beside its bound and one library call in the same type.  Then the
   blocked-ops path: the paper's unfused attention through the ``"cuda"``
   Backend protocol (``transpose``, ``matmul``, ``scale``,
   ``ops.blocked_softmax``) at BERT-base, block 16, batch 4, held against
   the fused kernel and the reference backend; it must launch
   bwma_transpose and bwma_softmax once.
8. mla serve -- DeepSeek-V3's dense prefix at full width (3 layers,
   d_model 7168, 128 heads, MLA q_lora 1536 / kv_lora 512 / nope 128 / rope
   64 / v 128, SwiGLU d_ff 18432, vocab 129280; random weights drawn on the
   card from a seed) through the continuous engine with the ``"cuda"``
   backend, on the traffic of phase 6.  Gates, in fp32: greedy tokens equal
   ``Server.generate`` under the same margin rule; mla_paged_attention_decode
   launches == 3 x decode steps; paged_copy launches == 2 x COW copies >= 2;
   a clean pool audit; a ``"reference"`` engine run launches no kernel.
   Timed in bf16 as in phase 6.

Then the per-kernel summary line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Any failure raises: the exit code is then
not 0 and the last line is not printed.  Imports only ``repro_torch``,
torch, numpy and the standard library.
"""
from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet (spec, not measured): fp32 outside the tensor
# cores, and HBM3 bandwidth.  Both assume the full 700 W power limit.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Kernel vs plain: max |kernel - plain| <= 2e-5 * max |plain|.  Both sum the
# same fp32 products in another order (the GEMM over up to K = 3072, the
# attention over 512 keys with an online softmax); 2e-5 is the JAX suite's
# op-level tolerance.
KERNEL_RTOL = 2e-5
# Encoder vs the reference backend and vs encoder_rwma: the JAX suite's
# end-to-end tolerances (tests/test_backend.py).
E2E_VS_REFERENCE = 1e-4
E2E_VS_RWMA = 5e-4
LAUNCHES_PER_FORWARD = {"bwma_gemm": 60, "bwma_fused_ffn": 12,
                        "bwma_layernorm": 24, "bwma_attention": 12}
SERVING_KERNELS = ("rwma_gemm", "paged_attention_decode", "paged_copy")
MLA_KERNELS = ("mla_paged_attention_decode", "bwma_softmax", "bwma_transpose")
REPLACES = {
    "bwma_gemm": "src/repro/kernels/bwma_gemm.py:26",
    "bwma_fused_ffn": "src/repro/kernels/bwma_fused_ffn.py:21",
    "bwma_layernorm": "src/repro/kernels/bwma_layernorm.py:18",
    "bwma_attention": "src/repro/kernels/bwma_attention.py:36",
    "rwma_gemm": "src/repro/kernels/rwma_gemm.py:17",
    "paged_attention_decode": "src/repro/kernels/paged_attention.py:65",
    "paged_copy": "src/repro/kernels/paged_attention.py:262",
    "mla_paged_attention_decode": "src/repro/kernels/paged_attention.py:165",
    "bwma_softmax": "src/repro/kernels/bwma_softmax.py:20",
    "bwma_transpose": "src/repro/kernels/bwma_transpose.py:21",
}
SOURCES = {
    "bwma_gemm": "src/repro_torch/kernels/csrc/bwma_gemm.cu",
    "bwma_fused_ffn": "src/repro_torch/kernels/csrc/bwma_gemm.cu",
    "bwma_layernorm": "src/repro_torch/kernels/csrc/bwma_layernorm.cu",
    "bwma_attention": "src/repro_torch/kernels/csrc/bwma_attention.cu",
    "rwma_gemm": "src/repro_torch/kernels/csrc/rwma_gemm.cu",
    "paged_attention_decode": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "paged_copy": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "mla_paged_attention_decode": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "bwma_softmax": "src/repro_torch/kernels/csrc/bwma_softmax.cu",
    "bwma_transpose": "src/repro_torch/kernels/csrc/bwma_transpose.cu",
}
# NVIDIA H100 SXM data sheet (spec): dense bf16 on the tensor cores, for the
# bound of an operation on bf16 inputs.
PEAK_BF16_FLOPS = 989e12
# Paged decode vs its plain version: fp32 pools within the JAX suite's TOL
# (tests/test_paged_kernels.py: online-softmax reassociation); bf16 pools
# within one bf16 rounding of the plain output (2^-7 of its magnitude; both
# compute in fp32 and round once) plus that same 1e-6.
PAGED_TOL = 1e-6
BF16_ROUNDING = 2.0 ** -7
# Greedy tokens against the single-request baseline: a divergence must fall
# at a step where the baseline's top-2 logit margin is below this.
MARGIN = 1e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, samples: int = 25, inner: int = 10) -> float:
    """Median over ``samples`` of the device time of ``inner`` back-to-back
    calls, per call, from CUDA events (after a warm-up)."""
    return statistics.median(time_samples(fn, samples, inner))


def time_samples(fn, samples: int, inner: int) -> list:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return times


def host_us(fn, calls: int = 50, repeats: int = 10) -> float:
    """The host's time per call of ``fn`` in microseconds: the least over
    ``repeats`` of ``calls`` calls issued back to back with no synchronise
    between them, so that it counts the wrapper's launch path alone (the
    least, because other work on the machine's shared cores only adds)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return min(times)


# Kernels a wrapper launches after its first one in the same call (the
# paged decode's combine pass): their time adds to the wrapper's kernel, but
# they are not a launch of their own.
FOLLOW_UP_KERNELS = ("paged_decode_combine_kernel",)


def device_profile(fn, calls: int = 20, want: str = "all") -> dict:
    """``calls`` calls of ``fn`` under torch.profiler, after a warm-up:
    ``{key: (device ms, launches)}`` with the port's kernels by name
    (:func:`kernel_of`; a follow-up kernel's time counts, its event is not a
    launch), ``"follow-up"`` for the follow-up kernels alone and ``"all"``
    for every device event.  A session
    that records no ``want`` event is run again, up to three sessions: the
    profiler sometimes returns one without the device events of work that
    ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        by = {}
        for evt in prof.events():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            ms = (evt.time_range.end - evt.time_range.start) / 1e3
            launch = not any(k in evt.name for k in FOLLOW_UP_KERNELS)
            for key in (kernel_of(evt.name), "all") + (() if launch else ("follow-up",)):
                t, n = by.get(key, (0.0, 0))
                by[key] = (t + ms, n + launch)
        if want in by:
            return by
    raise AssertionError(f"the profiler recorded no {want} event in three sessions")


def call_device_ms(fn, calls: int = 20) -> float:
    """The device time per call of ``fn``, every kernel and copy it runs."""
    return device_profile(fn, calls)["all"][0] / calls


def device_and_host(kernel: str, call, library=None) -> dict:
    """A kernel row's device ms per launch of the port's ``kernel`` inside
    ``call``, from the profiler: the kernel's own duration (with its
    follow-up kernels', also given alone where it has any), without the
    host's time between launches that the CUDA-event times of a short
    kernel include; its wrapper's host µs per call; and the library call's
    device ms per call (None without one)."""
    by = device_profile(call, want=kernel)
    t, n = by[kernel]
    row = {"device_ms": t / n, "host_us": host_us(call),
           "library_device_ms": None if library is None else call_device_ms(library)}
    if "follow-up" in by:
        row["follow_up_device_ms"] = by["follow-up"][0] / n
    return row


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(n_bytes: float, flops: float, peak: float = PEAK_FP32_FLOPS) -> tuple:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def _lead(*tensors) -> int:
    import torch

    return math.prod(torch.broadcast_shapes(*(t.shape[:-4] for t in tensors)))


def layer_cases(cfg, batch, gen, device):
    """The operands one encoder layer gives each kernel, at the encoder's
    scale: random weights and input, activations from the reference path.
    Returns ``{kernel: [case, ...]}``, one case per launch in the layer; a
    case holds the kernel call, its plain version, one library call for the
    same function on the unblocked operands (or None), the input bytes and
    the operations the function needs on these (blocked) inputs."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import blockwise as bw
    from repro_torch.core import encoder as enc
    from repro_torch.kernels.bwma_attention import attention_plain, bwma_attention
    from repro_torch.kernels.bwma_fused_ffn import bwma_fused_ffn, ffn_plain
    from repro_torch.kernels.bwma_gemm import (
        CTA_TILES,
        bwma_gemm,
        gemm_plain,
        gemm_plan,
        launch_gemm,
    )
    from repro_torch.kernels.bwma_layernorm import bwma_layernorm, layernorm_plain

    lo = cfg.layout
    S, d, dh, f = cfg.seq_len, cfg.d_model, cfg.d_head, cfg.d_ff
    p = enc.init_layer_params(cfg, gen, device)
    for name, base in (("ln1_g", 1.0), ("ln1_b", 0.0), ("b1", 0.0)):
        noise = torch.randn(p[name].shape, generator=gen, device=gen.device)
        p[name] = (base + 0.1 * noise).to(device)
    pb = enc.block_layer_params(p, cfg, device)
    x_rw = torch.randn(batch, S, d, generator=gen, device=gen.device).to(device)
    xb = bw.block(x_rw, lo)
    xh = bw.add_head_axis(xb)
    q, k, v = (bw.bw_matmul(xh, bw.Blocked(pb[n], (d, dh), lo)) for n in ("wq", "wk", "wv"))
    scale = 1.0 / float(dh) ** 0.5
    ctx = bw.bw_attention(q, k, v, scale=scale)
    att_all = bw.merge_heads(ctx)
    proj = bw.bw_matmul(att_all, bw.Blocked(pb["wo"], (att_all.shape[1], d), lo))
    ln_in = bw.bw_add(xb, proj)
    x1 = bw.bw_layernorm(ln_in, pb["ln1_g"], pb["ln1_b"])
    act = bw.bw_map(bw.bw_bias(bw.bw_matmul(x1, bw.Blocked(pb["w1"], (d, f), lo)),
                               pb["b1"]), bw.gelu)
    # the kernels take contiguous operands, as the "cuda" backend hands them
    q, k, v, att_all, ln_in, x1, act = (
        bw.Blocked(t.data.contiguous(), t.shape, t.layout)
        for t in (q, k, v, att_all, ln_in, x1, act))

    def rw(t):
        return t.unblock().contiguous()

    q_rw, k_rw, v_rw = rw(q), rw(k), rw(v)
    ctx_rw = torch.cat(list(rw(ctx).unbind(1)), dim=-1)  # (batch, S, h * d_head)
    ln_rw, act_rw = rw(ln_in), rw(act)
    flat_x1 = rw(x1).reshape(-1, d)
    add_act = getattr(torch, "_addmm_activation", None)  # one cuBLASLt call: gelu(b + x @ w)

    def gemm_flops(a, b):
        gm, gk, bm, bk = a.shape[-4:]
        gn, bn = b.shape[-3], b.shape[-1]
        return 2.0 * _lead(a, b) * gm * bm * gn * bn * gk * bk

    def tiling(kernel, a, b, bias=None):
        """The plan's CTA tile, every tile that spans the blocks, and a
        launch at a given tile (not counted: the sweep is no main-path run)."""
        gm, _, bm, _ = a.shape[-4:]
        gn, bn = b.shape[-3], b.shape[-1]
        return dict(cta_tile=list(gemm_plan(gm * bm, gn * bn, bm, bn, _lead(a, b))),
                    tiles=[t for t in CTA_TILES if t[0] % bm == 0 and t[1] % bn == 0],
                    at_tile=lambda t: launch_gemm(kernel, a, b, bias, t))

    def gemm_case(label, a, b, lib_a, lib_b):
        return dict(label=label, call=lambda: bwma_gemm(a, b), plain=lambda: gemm_plain(a, b),
                    library=lambda: torch.matmul(lib_a, lib_b), in_bytes=nbytes(a, b),
                    flops=gemm_flops(a, b), crop=None, **tiling("bwma_gemm", a, b))

    g1, b1 = pb["ln1_g"], pb["ln1_b"]
    gs, gd, bq, bd = q.data.shape[-4:]
    return {
        "bwma_gemm": [
            gemm_case(n, xh.data, pb[n], x_rw.unsqueeze(1), p[n]) for n in ("wq", "wk", "wv")
        ] + [
            gemm_case("wo", att_all.data, pb["wo"], ctx_rw, p["wo"]),
            gemm_case("w2", act.data, pb["w2"], act_rw, p["w2"]),
        ],
        "bwma_fused_ffn": [dict(
            label="w1", call=lambda: bwma_fused_ffn(x1.data, pb["w1"], pb["b1"]),
            plain=lambda: ffn_plain(x1.data, pb["w1"], pb["b1"]),
            library=(lambda: add_act(p["b1"], flat_x1, p["w1"], use_gelu=True))
            if add_act else None,
            in_bytes=nbytes(x1.data, pb["w1"], pb["b1"]),
            flops=gemm_flops(x1.data, pb["w1"]), crop=None,
            **tiling("bwma_fused_ffn", x1.data, pb["w1"], pb["b1"]),
        )],
        "bwma_layernorm": [dict(
            label=label, call=lambda: bwma_layernorm(ln_in.data, g1, b1, d),
            plain=lambda: layernorm_plain(ln_in.data, g1, b1, d),
            library=lambda: F.layer_norm(ln_rw, (d,), p["ln1_g"], p["ln1_b"], 1e-5),
            in_bytes=nbytes(ln_in.data, g1, b1), flops=8.0 * ln_in.data.numel(), crop=None,
        ) for label in ("ln1", "ln2")],
        "bwma_attention": [dict(
            label="attention",
            call=lambda: bwma_attention(q.data, k.data, v.data, scale=scale, s_logical=S),
            plain=lambda: attention_plain(q.data, k.data, v.data, scale=scale, s_logical=S),
            library=lambda: F.scaled_dot_product_attention(q_rw, k_rw, v_rw, scale=scale),
            in_bytes=nbytes(q.data, k.data, v.data),
            # q k^T and p v over the keys this input holds (s_logical of them)
            flops=4.0 * _lead(q.data, k.data, v.data) * gs * bq * S * gd * bd,
            crop=(q.layout, q.shape),
        )],
    }


def compare(out, want, crop):
    """(max abs error, max abs error / max |plain|), over logical rows only
    for attention, whose padded query rows are garbage by design."""
    from repro_torch.core.layout import from_blockwise

    if crop is not None:
        layout, shape = crop
        out, want = from_blockwise(out, layout, shape), from_blockwise(want, layout, shape)
    err = (out - want).abs().max().item()
    return err, err / max(want.abs().max().item(), 1e-30)


def tile_sweep(at_tile, tiles, want, what: str) -> dict:
    """Every CTA tile in ``tiles``, held against the plain version and timed
    alike, so that the plan's tile can be read against the others."""
    by_tile = {}
    for tile in tiles:
        _, rel = compare(at_tile(tile), want, None)
        if not rel <= KERNEL_RTOL:
            raise AssertionError(f"{what} at CTA tile {tile}: rel err {rel} > {KERNEL_RTOL}")
        by_tile["x".join(map(str, tile))] = time_ms(lambda: at_tile(tile), samples=10, inner=5)
    return by_tile


def kernel_phase(torch, gen):
    from repro_torch.core import encoder as enc

    configs = [
        ("bert-base block 16", enc.bert_base_config(block=16, n_layers=1), 4, True),
        ("bert-base block 128", enc.bert_base_config(block=128, n_layers=1), 4, True),
        ("ragged block 16", enc.EncoderConfig(seq_len=45, d_model=72, n_heads=2, d_head=20,
                                              d_ff=80, n_layers=1, block=16), 2, False),
    ]
    summary = {}
    for cfg_name, cfg, batch, timed in configs:
        cases = layer_cases(cfg, batch, gen, "cuda")
        for kernel, entries in cases.items():
            row = {"phase": "kernels", "config": cfg_name, "batch": batch, "kernel": kernel,
                   "cases": []}
            tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                   "bytes_ms": 0.0, "ops_ms": 0.0, "device_ms": 0.0, "host_us": 0.0,
                   "library_device_ms": 0.0}
            has_library = True
            worst = 0.0
            for c in entries:
                out = c["call"]()
                want = c["plain"]()
                torch.cuda.synchronize()
                if not torch.isfinite(want).all():
                    raise AssertionError(f"{kernel} {cfg_name} {c['label']}: plain not finite")
                err, rel = compare(out, want, c["crop"])
                worst = max(worst, err)
                case = {"op": c["label"], "max_abs_err": err, "rel_err": rel}
                if not rel <= KERNEL_RTOL:
                    raise AssertionError(
                        f"{kernel} {cfg_name} {c['label']}: rel err {rel} > {KERNEL_RTOL}")
                if timed:
                    n_bytes = c["in_bytes"] + nbytes(out)
                    b, kind = bound_ms(n_bytes, c["flops"])
                    case.update(ms=time_ms(c["call"]), plain_ms=time_ms(c["plain"]),
                                bound_ms=b, bound_by=kind)
                    if "cta_tile" in c:  # the GEMMs: CTA tile, fp32 peak share, sweep
                        case.update(cta_tile=c["cta_tile"],
                                    peak_share=c["flops"] / PEAK_FP32_FLOPS * 1e3 / case["ms"],
                                    ms_by_tile=tile_sweep(c["at_tile"], c["tiles"], want,
                                                          f"{kernel} {cfg_name} {c['label']}"))
                    library = c["library"]
                    case["library_ms"] = time_ms(library) if library else None
                    case.update(device_and_host(kernel, c["call"], library))
                    for key in ("ms", "plain_ms", "bound_ms", "device_ms", "host_us"):
                        tot[key] += case[key]
                    tot["bytes_ms"] += n_bytes / PEAK_BYTES_PER_S * 1e3
                    tot["ops_ms"] += c["flops"] / PEAK_FP32_FLOPS * 1e3
                    if library:
                        tot["library_ms"] += case["library_ms"]
                        tot["library_device_ms"] += case["library_device_ms"]
                    else:
                        has_library = False
                del out, want
                row["cases"].append(case)
            row["max_abs_err"] = worst
            if timed:
                row["per_layer"] = {k: tot[k] for k in ("ms", "plain_ms", "bound_ms",
                                                        "device_ms", "host_us")}
                for key in ("library_ms", "library_device_ms"):
                    row["per_layer"][key] = tot[key] if has_library else None
                row["per_layer"]["bound_by"] = (
                    "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations")
            emit(row)
            summary.setdefault(kernel, {})[cfg_name] = row
        del cases
        torch.cuda.empty_cache()
    return summary


def attention_phase(torch, gen) -> dict:
    """bwma_attention at BERT-base shapes (12 heads of 512 x 64), blocks 16
    and 128, batches 4 and 1: held against its plain version over the
    logical rows, timed beside the plain version, SDPA on the unblocked
    operands (a yardstick only) and the bound, with the plan's CTA tile and
    its share of the fp32 peak, each over the padded width the kernel
    computes and over the logical d_head.  Returns the rows by (block,
    batch)."""
    import torch.nn.functional as F

    from repro_torch.core.layout import BlockLayout, from_blockwise, to_blockwise
    from repro_torch.kernels.bwma_attention import (
        attention_plain,
        attention_plan,
        bwma_attention,
    )

    S, H, dh = 512, 12, 64
    scale = dh ** -0.5
    rows = {}
    for block in (16, 128):
        lo = BlockLayout(block, block)
        for batch in (4, 1):
            q_rw, k_rw, v_rw = (torch.randn(batch, H, S, dh, generator=gen,
                                            device=gen.device).to("cuda") for _ in range(3))
            q, k, v = (to_blockwise(t, lo) for t in (q_rw, k_rw, v_rw))
            gs, gd, bm, bd = q.shape[-4:]
            crop = (lo, (S, dh))
            got = bwma_attention(q, k, v, scale=scale, s_logical=S)
            want = attention_plain(q, k, v, scale=scale, s_logical=S)
            torch.cuda.synchronize()
            err, rel = compare(got, want, crop)
            what = f"bwma_attention block {block} batch {batch}"
            row = {"phase": "attention", "block": block, "batch": batch,
                   "max_abs_err": err, "rel_err": rel}
            if not (rel <= KERNEL_RTOL and torch.isfinite(want).all()):
                emit(row)
                raise AssertionError(f"{what}: rel err {rel} > {KERNEL_RTOL}")
            # q k^T and p v over the padded rows and width the kernel computes,
            # and over the logical d_head alone (at block 128 half the padded
            # width is zero columns)
            flops = 4.0 * batch * H * gs * bm * S * gd * bd
            flops_logical = 4.0 * batch * H * gs * bm * S * dh
            b_ms, kind = bound_ms(nbytes(q, k, v, got), flops)
            b_logical_ms, _ = bound_ms(nbytes(q, k, v, got), flops_logical)
            row.update(
                cta_tile=list(attention_plan(gd * bd)),
                ms=time_ms(lambda: bwma_attention(q, k, v, scale=scale, s_logical=S)),
                plain_ms=time_ms(lambda: attention_plain(q, k, v, scale=scale, s_logical=S),
                                 samples=5, inner=2),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    q_rw, k_rw, v_rw, scale=scale)),
                bound_ms=b_ms, bound_by=kind, bound_logical_ms=b_logical_ms,
                work=f"BERT-base attention, {batch} x {H} heads of {S} x {dh}, block "
                     f"{block} (padded width {gd * bd})")
            row["peak_share"] = flops / PEAK_FP32_FLOPS * 1e3 / row["ms"]
            row["peak_share_logical"] = flops_logical / PEAK_FP32_FLOPS * 1e3 / row["ms"]
            row.update(device_and_host(
                "bwma_attention", lambda: bwma_attention(q, k, v, scale=scale, s_logical=S),
                lambda: F.scaled_dot_product_attention(q_rw, k_rw, v_rw, scale=scale)))
            emit(row)
            rows[(block, batch)] = row
            # bf16 q/k/v: widened on the device, the fp32 kernel, one rounding
            q16, k16, v16 = (t.to(torch.bfloat16) for t in (q, k, v))
            got = bwma_attention(q16, k16, v16, scale=scale, s_logical=S)
            want = attention_plain(q16, k16, v16, scale=scale, s_logical=S)
            torch.cuda.synchronize()
            got, want = (from_blockwise(t, lo, (S, dh)).float() for t in (got, want))
            err = (got - want).abs()
            row = {"phase": "attention", "block": block, "batch": batch, "dtype": "bfloat16",
                   "max_abs_err": err.max().item(),
                   "ok": bool(torch.all(err <= BF16_ROUNDING * want.abs() + PAGED_TOL))}
            if not row["ok"]:
                emit(row)
                raise AssertionError(f"{what} bf16: not within one bf16 rounding")

            def call16():
                return bwma_attention(q16, k16, v16, scale=scale, s_logical=S)

            qkv16 = [t.to(torch.bfloat16) for t in (q_rw, k_rw, v_rw)]

            def library16():
                return F.scaled_dot_product_attention(*qkv16, scale=scale)

            row.update(ms=time_ms(call16), call_device_ms=call_device_ms(call16),
                       library_ms=time_ms(library16),
                       **device_and_host("bwma_attention", call16, library16))
            emit(row)
            del q, k, v, q_rw, k_rw, v_rw, q16, k16, v16, qkv16, got, want, err
    torch.cuda.empty_cache()
    return rows


def layernorm_phase(torch, gen) -> dict:
    """bwma_layernorm at BERT-base shapes (rows of d_model 768), blocks 16
    and 128, batches 4 and 1, with x and gamma/beta in fp32, x in bf16 with
    fp32 gamma/beta, and all in bf16: held against its plain version (fp32
    within 2e-5 of the plain's magnitude, bf16 within one bf16 rounding),
    timed by CUDA events and by the profiler's device time per launch, with
    the wrapper's host µs per call, F.layer_norm on the unblocked rows in the
    same types as the yardstick, the bytes bound and the plan.  Returns the
    rows by (block, batch, x dtype, gamma/beta dtype)."""
    import torch.nn.functional as F

    from repro_torch.core.blockwise import block_vector
    from repro_torch.core.layout import BlockLayout, to_blockwise
    from repro_torch.kernels.bwma_layernorm import bwma_layernorm, layernorm_plain, layernorm_plan

    S, d = 512, 768
    f32, bf16 = torch.float32, torch.bfloat16
    rows = {}
    for block in (16, 128):
        lo = BlockLayout(block, block)
        for batch in (4, 1):
            x_rw = torch.randn(batch, S, d, generator=gen, device=gen.device).to("cuda")
            g_rw = (1.0 + 0.1 * torch.randn(d, generator=gen, device=gen.device)).to("cuda")
            b_rw = (0.1 * torch.randn(d, generator=gen, device=gen.device)).to("cuda")
            for x_dtype, p_dtype in ((f32, f32), (bf16, f32), (bf16, bf16)):
                xr, gr, br = x_rw.to(x_dtype), g_rw.to(p_dtype), b_rw.to(p_dtype)
                x = to_blockwise(xr, lo).contiguous()
                g, b = block_vector(gr, lo), block_vector(br, lo)
                names = [str(t).split(".")[-1] for t in (x_dtype, p_dtype)]
                what = f"bwma_layernorm block {block} batch {batch} {'/'.join(names)}"
                row = {"phase": "layernorm", "block": block, "batch": batch,
                       "dtype": names[0], "param_dtype": names[1]}

                def gate(got, want, label):
                    got, want = got.float(), want.float()
                    err = (got - want).abs()
                    row[label] = err.max().item()
                    ok = (row[label] <= KERNEL_RTOL * want.abs().max().item()
                          if x_dtype == f32 else
                          bool(torch.all(err <= BF16_ROUNDING * want.abs() + PAGED_TOL)))
                    if not (ok and torch.isfinite(want).all()):
                        emit(row)
                        raise AssertionError(f"{what} ({label}): max err {row[label]}")

                def call():
                    return bwma_layernorm(x, g, b, d)

                got = call()
                want = layernorm_plain(x, g, b, d)
                torch.cuda.synchronize()
                if got.dtype != x_dtype:
                    raise AssertionError(f"{what}: result {got.dtype}")
                gate(got, want, "max_abs_err")
                per_lane, looped = layernorm_plan(d, x_dtype)
                b_ms, kind = bound_ms(nbytes(x, g, b, got), 8.0 * x.numel())
                row.update(plan={"vectors_per_lane": per_lane, "looped": looped},
                           ms=time_ms(call), plain_ms=time_ms(lambda: layernorm_plain(
                               x, g, b, d), samples=5, inner=2),
                           library_ms=time_ms(lambda: F.layer_norm(xr, (d,), gr, br, 1e-5))
                           if p_dtype == x_dtype else None,
                           bound_ms=b_ms, bound_by=kind,
                           **device_and_host("bwma_layernorm", call, (lambda: F.layer_norm(
                               xr, (d,), gr, br, 1e-5)) if p_dtype == x_dtype else None))
                row["work"] = (f"BERT-base LayerNorm, {batch} x {S} rows of {d}, block "
                               f"{block}, x {names[0]}, gamma/beta {names[1]}")
                emit(row)
                rows[(block, batch) + tuple(names)] = row
                del x, g, b, xr, gr, br, got, want
            del x_rw, g_rw, b_rw
    torch.cuda.empty_cache()
    return rows


def bf16_dense_check(torch, gen, kernels) -> dict:
    """``dense`` in bf16 (the configs' type) on both kernel routes at one
    starcoder2-7b product -- 128 tokens of d_model 4608 against W_q -- held
    against the xla route (``x @ w``) at 2e-2, the JAX suite's bf16
    tolerance.  Each route must launch its GEMM once and return bf16."""
    import dataclasses

    import repro_torch.configs as C
    from repro_torch.models.common import dense

    cfg = C.get_config("starcoder2-7b")
    d = cfg.d_model
    x = torch.randn(1, 128, d, generator=gen, device=gen.device).to("cuda", torch.bfloat16)
    w = (torch.randn(d, d, generator=gen, device=gen.device) * d ** -0.5).to(
        "cuda", torch.bfloat16)
    want = dense(cfg, x, w).float()  # the xla route
    out = {}
    for route, kernel in (("bwma", "bwma_gemm"), ("rwma", "rwma_gemm")):
        routed = dataclasses.replace(cfg, gemm_backend=route)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        got = dense(routed, x, w)
        torch.cuda.synchronize()
        counts = {k: n for k, n in kernels.launch_counts().items() if n}
        err = (got.float() - want).abs()
        row = {"phase": "bf16_dense", "route": route, "shape": [128, d, d],
               "dtype": str(got.dtype).split(".")[-1], "launches": counts,
               "max_abs_err": err.max().item(),
               "ok": bool(torch.all(err <= 2e-2 + 2e-2 * want.abs()))}
        emit(row)
        if not (row["ok"] and got.dtype == torch.bfloat16 and counts == {kernel: 1}):
            raise AssertionError(f"bf16 dense, route {route}: {row}")
        out[route] = row
    del x, w, want
    return out


def kernel_of(name: str) -> str:
    """The port's kernel a profiler event belongs to, or "other"."""
    if "gemm_kernel<" in name:  # gemm_tile.cuh: <CM, CN, TM, TN, FUSED, RWMA>
        if "true, false>" in name:
            return "bwma_fused_ffn"
        return "rwma_gemm" if "false, true>" in name else "bwma_gemm"
    for key, pattern in (("rwma_gemm", "rwma_any_tile_kernel"),
                         ("bwma_layernorm", "bwma_layernorm_kernel"),
                         ("bwma_attention", "bwma_attention_kernel"),
                         ("paged_attention_decode", "paged_decode_kernel"),
                         ("paged_attention_decode", "paged_decode_combine_kernel"),
                         ("paged_copy", "paged_copy_kernel"),
                         ("mla_paged_attention_decode", "mla_decode_kernel"),
                         ("bwma_softmax", "bwma_softmax_kernel"),
                         ("bwma_transpose", "bwma_transpose_kernel")):
        if pattern in name:
            return key
    return "other"


def csrc_constant(source: str, name: str) -> int:
    """A ``constexpr int`` of one of the port's CUDA sources."""
    text = (SRC / "repro_torch" / "kernels" / "csrc" / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def port_kernel_names() -> set:
    """The name of every ``__global__`` function in the port's CUDA sources,
    read from the sources themselves, so that it does not lean on the
    patterns of :func:`kernel_of`."""
    kernel = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*)?"
                        r"(\w+)\s*\(")
    return {name for path in (SRC / "repro_torch" / "kernels" / "csrc").glob("*.cu*")
            for name in kernel.findall(path.read_text())}


def profile_forward(torch, forward) -> dict:
    """One call under torch.profiler: the device time by kernel (the port's
    kernels by name, the rest under "other", with its five largest names),
    the device window (first kernel start to last kernel end) and the share
    of it in which no kernel ran."""
    from torch.profiler import ProfilerActivity, profile

    forward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        forward()
        torch.cuda.synchronize()
    by_kernel, other, spans = {}, {}, []
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((evt.time_range.start, evt.time_range.end))
        ms = (evt.time_range.end - evt.time_range.start) / 1e3
        key = kernel_of(evt.name)
        by_kernel[key] = by_kernel.get(key, 0.0) + ms
        if key == "other":
            other[evt.name[:80]] = other.get(evt.name[:80], 0.0) + ms
    if not spans:
        return {"profile": "no device events recorded"}
    # a port kernel that kernel_of does not know (a renamed template, say)
    # would have its time filed under "other"
    names = port_kernel_names()
    lost = [n for n in other for k in names if re.search(rf"\b{k}\b", n)]
    if lost:
        raise AssertionError(f"port kernels filed under other: {lost}")
    window = (max(e for _, e in spans) - min(s for s, _ in spans)) / 1e3
    busy = sum(by_kernel.values())
    top = sorted(other.items(), key=lambda kv: -kv[1])[:5]
    return {"device_window_ms": window, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / window, "device_ms_by_kernel": by_kernel,
            "top_other_ms": dict(top)}


def encoder_phase(torch, gen, kernels):
    from repro_torch.core import encoder as enc

    counted = None
    for block in (16, 128):
        cfg = enc.bert_base_config(block=block)
        params = enc.init_params(cfg, generator=gen, device="cuda")
        bp = enc.block_params(params, cfg, device="cuda")
        for batch in (4, None):
            shape = (cfg.seq_len, cfg.d_model) if batch is None else (batch, cfg.seq_len, cfg.d_model)
            x = torch.randn(shape, generator=gen, device=gen.device).to("cuda")
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            y = enc.encoder_bwma(bp, x, cfg, backend="cuda")
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            if any(counts[k] for k in SERVING_KERNELS + MLA_KERNELS):
                raise AssertionError(f"the encoder launched a serving kernel: {counts}")
            counts = {k: counts[k] for k in LAUNCHES_PER_FORWARD}
            if counts != LAUNCHES_PER_FORWARD:
                raise AssertionError(f"block {block} batch {batch}: launches {counts} "
                                     f"!= {LAUNCHES_PER_FORWARD} per forward")
            if counted is None:  # the main path: block 16, batch 4
                counted = counts
            y_ref = enc.encoder_bwma(bp, x, cfg, backend="reference")
            y_rw = enc.encoder_rwma(params, x, cfg)
            if tuple(y.shape) != shape or not torch.isfinite(y).all():
                raise AssertionError(f"block {block} batch {batch}: bad output {tuple(y.shape)}")
            err_ref = (y - y_ref).abs().max().item()
            err_rw = (y - y_rw).abs().max().item()
            row = {"phase": "encoder", "block": block, "batch": batch, "layers": cfg.n_layers,
                   "launches": counts, "max_abs_err_vs_reference": err_ref,
                   "max_abs_err_vs_rwma": err_rw}
            if not (err_ref <= E2E_VS_REFERENCE and err_rw <= E2E_VS_RWMA):
                emit(row)
                raise AssertionError(f"block {block} batch {batch}: encoder disagrees")
            # median and p90 of 100 forwards: p90 is the highest percentile
            # with at least ten samples beyond it
            fwd = sorted(time_samples(lambda: enc.encoder_bwma(bp, x, cfg, backend="cuda"),
                                      samples=100, inner=1))
            row.update(forward_ms=statistics.median(fwd), forward_p90_ms=fwd[89],
                       forward_samples=len(fwd))
            row["reference_forward_ms"] = time_ms(
                lambda: enc.encoder_bwma(bp, x, cfg, backend="reference"), samples=5, inner=1)
            row.update(profile_forward(
                torch, lambda: enc.encoder_bwma(bp, x, cfg, backend="cuda")))
            emit(row)
            del y, y_ref, y_rw
        del params, bp
        torch.cuda.empty_cache()
    return counted


def serving_kernel_phase(torch, gen):
    """rwma_gemm, paged_attention_decode and paged_copy against their plain
    versions at this slice's full-width shapes, timed.  Returns {kernel:
    summary row}; the rows' times are for the timed configuration named in
    their ``work`` key."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels.bwma_gemm import CTA_TILES, bwma_gemm
    from repro_torch.kernels.paged_attention import (
        copy_plain,
        decode_plain,
        decode_plan,
        paged_attention_decode,
        paged_copy,
    )
    from repro_torch.kernels.rwma_gemm import launch_rwma, rwma_gemm, rwma_plain, rwma_route
    from repro_torch.core.layout import BlockLayout, to_blockwise

    out = {}
    # -- rwma_gemm: one BERT-base encoder layer's six projections at batch 4
    # (M = 4 x 512), beside bwma_gemm at the same tiling
    d, f, M = 768, 3072, 4 * 512
    products = {"wq": (d, d), "wk": (d, d), "wv": (d, d), "wo": (d, d), "w1": (d, f),
                "w2": (f, d)}
    for block in (16, 128):
        lo = BlockLayout(block, block)
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
               "bwma_ms": 0.0, "device_ms": 0.0, "host_us": 0.0, "library_device_ms": 0.0}
        worst = bytes_ms = ops_ms = 0.0
        tiles = {}  # equal tiling: the blocked GEMM's plan for the same blocks
        for name, (k, n) in products.items():
            a = torch.randn(M, k, generator=gen, device=gen.device).to("cuda")
            w = (torch.randn(k, n, generator=gen, device=gen.device) * k ** -0.5).to("cuda")
            got = rwma_gemm(a, w, bm=block, bk=block, bn=block)
            want = rwma_plain(a, w, bm=block, bk=block, bn=block)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            rel = err / want.abs().max().item()
            if not rel <= KERNEL_RTOL:
                raise AssertionError(f"rwma_gemm block {block} {name}: rel err {rel}")
            worst = max(worst, err)
            ab, wb = to_blockwise(a, lo), to_blockwise(w, lo)
            b, _ = bound_ms(nbytes(a, w, got), 2.0 * M * k * n)
            bytes_ms += nbytes(a, w, got) / PEAK_BYTES_PER_S * 1e3
            ops_ms += 2.0 * M * k * n / PEAK_FP32_FLOPS * 1e3
            tot["ms"] += time_ms(lambda: rwma_gemm(a, w, bm=block, bk=block, bn=block))
            tot["plain_ms"] += time_ms(lambda: rwma_plain(a, w, bm=block, bk=block, bn=block))
            tot["library_ms"] += time_ms(lambda: torch.matmul(a, w))
            tot["bwma_ms"] += time_ms(lambda: bwma_gemm(ab, wb))
            tot["bound_ms"] += b
            for key, t in device_and_host("rwma_gemm",
                                          lambda: rwma_gemm(a, w, bm=block, bk=block, bn=block),
                                          lambda: torch.matmul(a, w)).items():
                tot[key] += t
            tiles[name] = list(rwma_route(M, k, n, block, block)[1])
            del a, w, got, want, ab, wb
        row = {"phase": "serving_kernels", "kernel": "rwma_gemm", "block": block,
               "max_abs_err": worst, "cta_tiles": tiles,
               "peak_share": ops_ms / tot["ms"], "bwma_peak_share": ops_ms / tot["bwma_ms"],
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "work": f"one BERT-base layer's six projections, M = 2048, block {block}",
               **tot}
        emit(row)
        if block == 16:
            out["rwma_gemm"] = row
    # -- rwma_gemm at the products the rwma serving run gives it (starcoder2-7b
    # widths): 128-token prefill chunks at tile 128, the 16-token tail chunk at
    # tile 16, and 24 tokens at tile 24, a tile outside the powers of two that
    # dense takes for such a token count; then tile 9 over 45 columns, the
    # general-tile kernel's route (rows of 45 floats have no 16-byte chunks)
    d, kv, f = 4608, 512, 18432
    for M, block, products in ((128, 128, ((d, d), (d, kv), (d, f), (f, d))),
                               (16, 16, ((d, d), (d, kv), (d, f), (f, d))),
                               (24, 24, ((d, d), (d, f), (f, d))),
                               (27, 9, ((45, 18),))):
        for k, n in products:
            a = torch.randn(M, k, generator=gen, device=gen.device).to("cuda")
            w = (torch.randn(k, n, generator=gen, device=gen.device) * k ** -0.5).to("cuda")
            got = rwma_gemm(a, w, bm=block, bk=block, bn=block)
            want = rwma_plain(a, w, bm=block, bk=block, bn=block)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            rel = err / want.abs().max().item()
            row = {"phase": "serving_kernels", "kernel": "rwma_gemm", "block": block,
                   "shape": [M, k, n], "max_abs_err": err, "rel_err": rel}
            if not rel <= KERNEL_RTOL:
                emit(row)
                raise AssertionError(f"rwma_gemm ({M},{k})@({k},{n}) block {block}: "
                                     f"rel err {rel}")
            b, kind = bound_ms(nbytes(a, w, got), 2.0 * M * k * n)
            route, tile = rwma_route(M, k, n, block, block)
            row.update(route=route, cta_tile=tile and list(tile))
            row.update(ms=time_ms(lambda: rwma_gemm(a, w, bm=block, bk=block, bn=block),
                                  samples=5, inner=2),
                       plain_ms=time_ms(lambda: rwma_plain(a, w, bm=block, bk=block,
                                                           bn=block), samples=5, inner=2),
                       library_ms=time_ms(lambda: torch.matmul(a, w), samples=5, inner=2),
                       bound_ms=b, bound_by=kind,
                       work="a starcoder2-7b projection of the rwma serving run"
                       if M != 27 else "the general-tile route, tile 9")
            row["peak_share"] = 2.0 * M * k * n / PEAK_FP32_FLOPS * 1e3 / row["ms"]
            if route == "tile_loop":  # the tiles that span the blocks (any, off 8..128)
                spans = [t for t in CTA_TILES if block not in _build.SUPPORTED_BLOCKS
                         or (t[0] % block == 0 and t[1] % block == 0)]
                row["ms_by_tile"] = tile_sweep(
                    lambda t: launch_rwma(a, w, block, block, block, t), spans, want,
                    f"rwma_gemm ({M},{k})@({k},{n}) block {block}")
            emit(row)
            del a, w, got, want
    # -- paged_attention_decode at starcoder2-7b decode shapes
    B, H, hkv, dh, page, maxp = 4, 36, 4, 128, 128, 16
    seq = [0, 127, 1000, 1900]
    num_pages = B * maxp + 1
    rng = np.random.default_rng(0)
    table = np.zeros((B, maxp), np.int32)
    phys = rng.permutation(np.arange(1, num_pages))
    for b, pos in enumerate(seq):
        used = pos // page + 1
        table[b, :used] = phys[b * maxp:b * maxp + used]  # unmapped: the null page
    table_t = torch.from_numpy(table).to("cuda")
    seq_t = torch.tensor(seq, dtype=torch.int32, device="cuda")
    n_keys = sum(p + 1 for p in seq)
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(B, 1, H, dh, generator=gen, device=gen.device).to("cuda", dtype)
        kp = torch.randn(num_pages, page, hkv, dh, generator=gen, device=gen.device).to(
            "cuda", dtype)
        vp = torch.randn(num_pages, page, hkv, dh, generator=gen, device=gen.device).to(
            "cuda", dtype)
        args = (q, kp, vp, table_t, seq_t)
        got = paged_attention_decode(*args).float()
        want = decode_plain(*args).float()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = PAGED_TOL if dtype == torch.float32 else None
        ok = (err <= tol) if tol is not None else bool(
            torch.all((got - want).abs() <= BF16_ROUNDING * want.abs() + PAGED_TOL))
        if not ok:
            raise AssertionError(f"paged_attention_decode {dtype}: max err {err}")
        # batch invariance (each slot alone, and behind maxp doubled by
        # null-page columns) and run-to-run bit identity
        full = paged_attention_decode(*args)
        wide = paged_attention_decode(q, kp, vp, torch.cat([table_t, torch.zeros_like(table_t)],
                                                           1), seq_t)
        for b in range(B):
            alone = paged_attention_decode(q[b:b + 1], kp, vp, table_t[b:b + 1], seq_t[b:b + 1])
            if not (torch.equal(alone[0], full[b]) and torch.equal(wide[b], full[b])):
                raise AssertionError(f"paged_attention_decode {dtype}: slot {b} is not "
                                     "batch invariant")
        if not torch.equal(paged_attention_decode(*args), full):
            raise AssertionError(f"paged_attention_decode {dtype}: not bit-identical run to run")
        split_keys, splits = decode_plan(page, maxp)
        ctas = sum(-(-(p + 1) // split_keys) for p in seq) * hkv  # G = 9: one CTA per kv head
        # the library yardstick: SDPA over the keys gathered per slot
        kg = kp[table_t.long()].reshape(B, maxp * page, hkv, dh).transpose(1, 2)
        vg = vp[table_t.long()].reshape(B, maxp * page, hkv, dh).transpose(1, 2)
        mask = (torch.arange(maxp * page, device="cuda")[None] <= seq_t[:, None].long())
        mask = mask[:, None, None, :]
        qs = q.transpose(1, 2)

        def library():
            return F.scaled_dot_product_attention(qs, kg, vg, attn_mask=mask, enable_gqa=True)

        esz = q.element_size()
        moved = (nbytes(q, table_t, seq_t) + 2 * n_keys * hkv * dh * esz + nbytes(q))
        peak = PEAK_FP32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
        b, kind = bound_ms(moved, 4.0 * H * dh * n_keys, peak=peak)
        row = {"phase": "serving_kernels", "kernel": "paged_attention_decode",
               "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
               "ms": time_ms(lambda: paged_attention_decode(*args)),
               "plain_ms": time_ms(lambda: decode_plain(*args)),
               "library_ms": time_ms(library), "bound_ms": b, "bound_by": kind,
               "split_keys": split_keys, "ctas": ctas, "grid": [B, hkv, splits],
               "batch_invariant": True, "bit_identical_run_to_run": True,
               "work": f"one layer's decode, B={B} H={H} Hkv={hkv} dh={dh} page={page} "
                       f"seq_pos={seq} ({str(dtype).split('.')[-1]} pools)",
               **device_and_host("paged_attention_decode",
                                 lambda: paged_attention_decode(*args), library)}
        emit(row)
        out.setdefault("paged_attention_decode", row)
        del q, kp, vp, kg, vg, full, wide
    # -- paged_copy: one COW event's copy of one pool, all 32 layers
    for dtype in (torch.float32, torch.bfloat16):
        pool = torch.randn(32, num_pages, page, hkv, dh, generator=gen,
                           device=gen.device).to("cuda", dtype)
        want = pool.clone()
        ptr = pool.data_ptr()
        paged_copy(pool, 3, 17)
        copy_plain(want, 3, 17)
        torch.cuda.synchronize()
        if not (torch.equal(pool, want) and pool.data_ptr() == ptr):
            raise AssertionError(f"paged_copy {dtype}: not bit-exact in place")
        page_bytes = pool[0, 0].numel() * pool.element_size()
        b, kind = bound_ms(2 * 32 * page_bytes, 0.0)
        row = {"phase": "serving_kernels", "kernel": "paged_copy",
               "dtype": str(dtype).split(".")[-1], "max_abs_err": 0.0,
               "ms": time_ms(lambda: paged_copy(pool, 5, 9)),
               "plain_ms": time_ms(lambda: copy_plain(pool, 5, 9)),
               "library_ms": time_ms(lambda: pool[:, 9].copy_(pool[:, 5])),
               "bound_ms": b, "bound_by": kind,
               "work": f"one pool of one COW event: 32 layers x one {page}-token page "
                       f"({str(dtype).split('.')[-1]})",
               **device_and_host("paged_copy", lambda: paged_copy(pool, 5, 9),
                                 lambda: pool[:, 9].copy_(pool[:, 5]))}
        emit(row)
        out.setdefault("paged_copy", row)
        del pool, want
    torch.cuda.empty_cache()
    return out


def serve_traffic(vocab: int):
    """8 prompts of 100-1500 tokens from a numpy seed; prompt 2 is the first
    700 tokens of prompt 0 (a partial tail page: copy-on-write on its first
    decode write).  Arrivals every 4 engine steps."""
    import numpy as np

    rng = np.random.default_rng(0)
    lens = rng.integers(100, 1501, size=8)
    lens[0] = 1200  # long enough that its full pages cover prompt 2's 700 tokens
    prompts = [rng.integers(0, vocab, size=(int(n),)).astype(np.int32) for n in lens]
    prompts[2] = prompts[0][:700].copy()
    return prompts, [4 * i for i in range(len(prompts))]


def margin_at(cfg, params, server, prompt, want, i, device="cuda"):
    """The baseline's top-2 logit margin at generated step ``i``, from
    stepping the port's ``model.prefill`` and ``model.decode_step`` along the
    baseline's own tokens, as ``Server.generate`` does."""
    import numpy as np
    import torch

    from repro_torch.models import model as M
    from repro_torch.serve.engine import bucket_tokens

    S = len(prompt)
    # the prompt shape Server.generate runs: bucketed where the family allows
    Sp = min(bucket_tokens(S, cfg.block), server.sc.max_len) \
        if M.supports_padded_prefill(cfg) else S
    padded = np.zeros((1, Sp), np.int32)
    padded[0, :S] = prompt
    logits, caches = M.prefill(cfg, params, {"tokens": torch.from_numpy(padded).to(device)},
                               S - 1)
    caches = server._grow_cache(caches, 1, S)
    for j in range(i):
        tok = torch.tensor([[int(want[j])]], device=device)
        logits, caches = M.decode_step(cfg, params, caches, tok, S + j)
    top2 = torch.topk(logits[0, -1].float(), 2).values
    return (top2[0] - top2[1]).item()


def agree(cfg, params, prompts, got, max_new, label, device="cuda"):
    """Greedy tokens ``got`` against the single-request ``Server.generate``
    under the margin rule.  Returns the agreed prefix lengths."""
    import numpy as np

    from repro_torch.serve import ServeConfig, Server

    server = Server(cfg, params, ServeConfig(max_len=2048), device=device)
    agreed = []
    for rid, prompt in enumerate(prompts):
        want = server.generate({"tokens": prompt[None]}, max_new)[0]
        mine = np.asarray(got[rid])
        if np.array_equal(mine, want):
            agreed.append(len(want))
            continue
        i = int(np.argmax(mine != want))
        margin = margin_at(cfg, params, server, prompt, want, i, device)
        agreed.append(i)
        if not margin < MARGIN:
            raise AssertionError(f"{label}: request {rid} diverges at step {i} where the "
                                 f"baseline's top-2 margin is {margin} >= {MARGIN}")
    return agreed


def run_engine(cfg, params, prompts, arrivals, max_new, device="cuda", **ec_kw):
    from repro_torch.serve import Engine, EngineConfig

    eng = Engine(cfg, params, EngineConfig(max_seqs=4, max_len=2048, page_size=128,
                                           prefill_chunk=128, **ec_kw), device=device)
    for rid, (p, t) in enumerate(zip(prompts, arrivals)):
        eng.submit(p, max_new, rid=rid, arrival_step=t)
    return eng


def drained_audit(eng):
    stats = eng.kv.audit()
    if stats.slot_held or eng.kv._pages:
        raise AssertionError(f"drained pool still has slot pages: {stats}")
    return stats


def gated_serve(torch, kernels, cfg, params, prompts, arrivals, max_new, decode_kernel):
    """The fp32 gates of one model through the continuous engine with the
    ``"cuda"`` backend, counts set to 0 just before the run and read just
    after: ``decode_kernel`` launched once per layer and decode step,
    paged_copy twice per COW copy (>= 1 copy), no other kernel, a clean
    audit, and greedy tokens equal to ``Server.generate`` under the margin
    rule; then a ``"reference"`` run on three of the prompts launches no
    kernel.  Returns the launch counts of the gated run."""
    import dataclasses

    eng = run_engine(cfg, params, prompts, arrivals, max_new, backend="cuda")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    got = [r.out_tokens for r in reqs]
    audit = drained_audit(eng)
    emit({"phase": "serve", "model": cfg.name, "run": "fp32 gates, backend cuda",
          "layers": cfg.n_layers, "requests": len(reqs),
          "prompt_lens": [len(p) for p in prompts], "decode_steps": eng.decode_steps,
          "prefill_chunks": eng.prefill_chunks, "cow_copies": eng.kv.cow_copies,
          "cached_prompt_tokens": [r.stats.cached_prompt_tokens for r in reqs],
          "launches": counts, "audit": dataclasses.asdict(audit), "wall_s": wall})
    if counts[decode_kernel] != cfg.n_layers * eng.decode_steps:
        raise AssertionError(f"{decode_kernel} launched {counts[decode_kernel]} times, not "
                             f"{cfg.n_layers} x {eng.decode_steps} decode steps")
    if eng.kv.cow_copies < 1 or counts["paged_copy"] != 2 * eng.kv.cow_copies:
        raise AssertionError(f"COW: {eng.kv.cow_copies} copies, paged_copy launched "
                             f"{counts['paged_copy']} times (want 2 per copy, >= 1 copy)")
    others = {k: n for k, n in counts.items() if n and k not in (decode_kernel, "paged_copy")}
    if others:
        raise AssertionError(f"the xla route launched other kernels: {others}")
    agreed = agree(cfg, params, prompts, got, max_new,
                   f"{cfg.name} fp32 engine vs Server.generate")
    emit({"phase": "serve", "model": cfg.name, "check": "tokens vs Server.generate (fp32)",
          "agreed_prefix": agreed, "of": max_new})

    sub = [prompts[0], prompts[2], prompts[1]]
    eng = run_engine(cfg, params, sub, [0, 4, 8], 8, backend="reference")
    kernels.reset_launch_counts()
    eng.run()
    torch.cuda.synchronize()
    ref_counts = kernels.launch_counts()
    drained_audit(eng)
    emit({"phase": "serve", "model": cfg.name, "run": "fp32, backend reference",
          "requests": len(sub), "cow_copies": eng.kv.cow_copies, "launches": ref_counts})
    if any(ref_counts.values()) or eng.kv.cow_copies < 1:
        raise AssertionError(f"reference backend: launches {ref_counts}, "
                             f"cow {eng.kv.cow_copies}")
    return counts


def timed_serve(torch, cfg16, params, prompts, arrivals, max_new) -> dict:
    """The bf16 serving numbers: the run's wall time with the deferred sync
    (as served), decode step times with one sync per step, TTFT, and one
    profiled decode step with 4 slots decoding."""
    eng = run_engine(cfg16, params, prompts, arrivals, max_new)  # deferred sync, as served
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    useful = sum(len(r.out_tokens) for r in reqs)
    drained_audit(eng)
    eng = run_engine(cfg16, params, prompts, arrivals, max_new)  # one sync per step
    decode_ms, decode_tokens = [], 0
    while eng.sched.has_work():
        chunks, steps = eng.prefill_chunks, eng.decode_steps
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t) * 1e3
        if eng.prefill_chunks == chunks and eng.decode_steps == steps + 1:
            decode_ms.append(dt)
            decode_tokens += eng.obs.registry.gauge("decode_batch_occupancy").value
    eng._flush_pending()
    reqs = [eng.sched.finished[r] for r in sorted(eng.sched.finished)]
    drained_audit(eng)
    decode_ms.sort()
    ttft_steps = [r.stats.ttft_steps for r in reqs]
    ttft_ms = [r.stats.ttft_s * 1e3 for r in reqs]
    # one profiled decode step: 4 slots decoding, no admission pending
    eng = run_engine(cfg16, params, prompts[3:7], [0, 0, 0, 0], max_new)
    while len(eng.sched.decoding) < 4:
        eng.step()
    prof = profile_forward(torch, eng.step)
    return {"phase": "serve", "model": cfg16.name, "run": "bf16 timed, backend cuda",
            "layers": cfg16.n_layers, "wall_s": wall, "generated_tokens": useful,
            "tok_s": useful / wall, "decode_step_ms_median": statistics.median(decode_ms),
            "decode_step_ms_p90": decode_ms[int(0.9 * (len(decode_ms) - 1))],
            "decode_steps_timed": len(decode_ms),
            "decode_tok_s": decode_tokens / (sum(decode_ms) / 1e3),
            "ttft_steps": ttft_steps, "ttft_ms": ttft_ms,
            "ttft_ms_median": statistics.median(ttft_ms), "profiled_decode_step": prof}


def serve_phase(torch, kernels):
    """starcoder2-7b at full width through the continuous engine."""
    import dataclasses

    import repro_torch.configs as C
    from repro_torch.models import model as M

    max_new = 64
    cfg = C.get_config("starcoder2-7b", dtype=torch.float32)
    prompts, arrivals = serve_traffic(cfg.vocab_size)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = M.init_params(cfg, gen, device="cuda")
    result = {"launches": gated_serve(torch, kernels, cfg, params, prompts, arrivals,
                                      max_new, "paged_attention_decode")}

    # -- the rwma route: 4 layers at full width, fp32
    cfg4 = dataclasses.replace(cfg, n_layers=4)
    params4 = dict(params, seg0={k: {n: t[:4] for n, t in v.items()}
                                 for k, v in params["seg0"].items()})
    short = [p[:400] for p in prompts[:3]]
    eng = run_engine(dataclasses.replace(cfg4, gemm_backend="rwma"), params4, short,
                     [0, 0, 0], 16)
    kernels.reset_launch_counts()
    reqs = eng.run()
    torch.cuda.synchronize()
    rwma_counts = kernels.launch_counts()
    drained_audit(eng)
    agreed = agree(cfg4, params4, short, [r.out_tokens for r in reqs], 16,
                   "rwma engine vs the xla route")
    emit({"phase": "serve", "run": "fp32, 4 layers, gemm_backend rwma",
          "launches": rwma_counts, "agreed_prefix": agreed, "of": 16})
    if not rwma_counts["rwma_gemm"]:
        raise AssertionError("the rwma route launched no rwma_gemm")
    result["rwma_launches"] = rwma_counts["rwma_gemm"]
    del params, params4, eng
    torch.cuda.empty_cache()

    # -- timed, bf16 (the config's type)
    cfg16 = C.get_config("starcoder2-7b")
    params = M.init_params(cfg16, gen, device="cuda")
    emit(timed_serve(torch, cfg16, params, prompts, arrivals, max_new))
    del params
    torch.cuda.empty_cache()
    return result


def mla_kernel_phase(torch, gen):
    """mla_paged_attention_decode, bwma_softmax and bwma_transpose against
    their plain versions at this slice's shapes, timed.  Returns {kernel:
    summary row}, each row's times for the configuration in its ``work``."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.core.layout import BlockLayout, to_blockwise
    from repro_torch.kernels.bwma_softmax import bwma_softmax, softmax_plain, softmax_plan
    from repro_torch.kernels.bwma_transpose import (bwma_transpose, transpose_plain,
                                                    transpose_plan)
    from repro_torch.kernels.paged_attention import mla_decode_plain, mla_paged_attention_decode

    out = {}
    # -- mla_paged_attention_decode at DeepSeek-V3 decode shapes
    B, H, r, dr, page, maxp = 4, 128, 512, 64, 128, 16
    scale = (128 + dr) ** -0.5  # (qk_nope + qk_rope) ** -0.5
    seq = [0, 127, 1000, 1900]
    num_pages = B * maxp + 1
    rng = np.random.default_rng(1)
    table = np.zeros((B, maxp), np.int32)
    phys = rng.permutation(np.arange(1, num_pages))
    for b, pos in enumerate(seq):
        used = pos // page + 1
        table[b, :used] = phys[b * maxp:b * maxp + used]  # unmapped: the null page
    table_t = torch.from_numpy(table).to("cuda")
    seq_t = torch.tensor(seq, dtype=torch.int32, device="cuda")
    n_keys = sum(p + 1 for p in seq)
    for dtype in (torch.float32, torch.bfloat16):
        q_lat, q_rope = (torch.randn(B, 1, H, n, generator=gen, device=gen.device).to(
            "cuda", dtype) for n in (r, dr))
        ckv, krope = (torch.randn(num_pages, page, n, generator=gen, device=gen.device).to(
            "cuda", dtype) for n in (r, dr))
        args = (q_lat, q_rope, ckv, krope, table_t, seq_t)
        got = mla_paged_attention_decode(*args, scale=scale).float()
        want = mla_decode_plain(*args, scale=scale).float()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ok = err <= PAGED_TOL if dtype == torch.float32 else bool(
            torch.all((got - want).abs() <= BF16_ROUNDING * want.abs() + PAGED_TOL))
        name = str(dtype).split(".")[-1]
        if not ok:
            raise AssertionError(f"mla_paged_attention_decode {name}: max err {err}")
        # the library yardstick: SDPA over the latents gathered per slot, the
        # latent and rope parts concatenated, one shared kv head
        cg = ckv[table_t.long()].reshape(B, 1, maxp * page, r)
        kg = torch.cat([cg, krope[table_t.long()].reshape(B, 1, maxp * page, dr)], -1)
        qs = torch.cat([q_lat, q_rope], -1).transpose(1, 2)  # (B, H, 1, r + dr)
        mask = (torch.arange(maxp * page, device="cuda")[None] <= seq_t[:, None].long())
        mask = mask[:, None, None, :]

        def library():
            return F.scaled_dot_product_attention(qs, kg, cg, attn_mask=mask, scale=scale,
                                                  enable_gqa=True)

        esz = ckv.element_size()
        moved = nbytes(q_lat, q_rope, table_t, seq_t) + n_keys * (r + dr) * esz + nbytes(q_lat)
        peak = PEAK_FP32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
        # per head and key: 2 (r + dr) for the score, 2 r for p @ c_kv
        b_ms, kind = bound_ms(moved, 2.0 * H * n_keys * (2 * r + dr), peak=peak)
        row = {"phase": "mla_kernels", "kernel": "mla_paged_attention_decode", "dtype": name,
               "max_abs_err": err,
               "ms": time_ms(lambda: mla_paged_attention_decode(*args, scale=scale)),
               "plain_ms": time_ms(lambda: mla_decode_plain(*args, scale=scale)),
               "library_ms": time_ms(library), "bound_ms": b_ms, "bound_by": kind,
               "work": f"one layer's decode, B={B} H={H} r={r} dr={dr} page={page} "
                       f"seq_pos={seq} ({name} pools)",
               **device_and_host("mla_paged_attention_decode",
                                 lambda: mla_paged_attention_decode(*args, scale=scale),
                                 library)}
        emit(row)
        out.setdefault("mla_paged_attention_decode", row)
        del q_lat, q_rope, ckv, krope, cg, kg, qs
    # -- bwma_softmax at BERT-base attention-score shapes: 4 x 12 heads of 512 x 512
    S = 512
    rows_per_cta = csrc_constant("bwma_softmax.cu", "kRows")

    def softmax_ok(got, want, dtype):
        err = (got.float() - want.float()).abs().max().item()
        ok = (err <= KERNEL_RTOL * want.float().abs().max().item()
              if dtype == torch.float32 else bool(torch.all(
                  (got.float() - want.float()).abs()
                  <= BF16_ROUNDING * want.float().abs() + PAGED_TOL)))
        return ok, err

    scores = torch.randn(4, 12, S, S, generator=gen, device=gen.device).to("cuda") * 3
    for block in (16, 128):
        xb = to_blockwise(scores, BlockLayout(block, block)).contiguous()
        for n_logical in (S, 500):
            for dtype in (torch.float32, torch.bfloat16):
                x = xb.to(dtype)
                got = bwma_softmax(x, n_logical)
                want = softmax_plain(x, n_logical)
                torch.cuda.synchronize()
                ok, err = softmax_ok(got, want, dtype)
                name = str(dtype).split(".")[-1]
                per_lane, looped = softmax_plan(x.shape[-3] * block, dtype)
                row = {"phase": "mla_kernels", "kernel": "bwma_softmax", "block": block,
                       "n_logical": n_logical, "dtype": name, "max_abs_err": err,
                       "rows_per_cta": rows_per_cta, "vectors_per_lane": per_lane,
                       "looped": looped, "ctas": -(-x.numel() // (S * rows_per_cta))}
                if not ok:
                    emit(row)
                    raise AssertionError(f"bwma_softmax block {block} n {n_logical} {name}: "
                                         f"max err {err}")
                if n_logical == S:
                    lib_x = scores.to(dtype)
                    # bytes: the blocked input read once, the output written once
                    b_ms, kind = bound_ms(2 * nbytes(x), 5.0 * x.numel())
                    row.update(ms=time_ms(lambda: bwma_softmax(x, n_logical)),
                               plain_ms=time_ms(lambda: softmax_plain(x, n_logical)),
                               library_ms=time_ms(lambda: torch.softmax(lib_x, -1)),
                               bound_ms=b_ms, bound_by=kind,
                               work=f"BERT-base scores, 4 x 12 heads of {S} x {S}, "
                                    f"block {block}, {name}",
                               **device_and_host("bwma_softmax",
                                                 lambda: bwma_softmax(x, n_logical),
                                                 lambda: torch.softmax(lib_x, -1)))
                    del lib_x
                    if block == 16 and dtype == torch.float32:
                        out["bwma_softmax"] = row
                emit(row)
                del x, got, want
        del xb
    del scores
    # the looped path: rows wider than 2048 fp32 / 4096 bf16 columns
    for dtype, gn, n_logical in ((torch.float32, 17, 2100), (torch.bfloat16, 33, 4219)):
        x = (torch.randn(8, 1, gn, 128, 128, generator=gen, device=gen.device) * 3).to(
            "cuda", dtype)
        got = bwma_softmax(x, n_logical)
        want = softmax_plain(x, n_logical)
        torch.cuda.synchronize()
        ok, err = softmax_ok(got, want, dtype)
        name = str(dtype).split(".")[-1]
        per_lane, looped = softmax_plan(gn * 128, dtype)
        row = {"phase": "mla_kernels", "kernel": "bwma_softmax", "block": 128,
               "n_logical": n_logical, "dtype": name, "max_abs_err": err,
               "rows_per_cta": rows_per_cta, "vectors_per_lane": per_lane, "looped": looped,
               "work": f"8 x 128 rows of {gn * 128} padded columns, {name}"}
        if not (ok and looped):
            emit(row)
            raise AssertionError(f"bwma_softmax looped {name}: max err {err}, plan {looped}")
        row.update(bound_ms=bound_ms(2 * nbytes(x), 5.0 * x.numel())[0],
                   **device_and_host("bwma_softmax", lambda: bwma_softmax(x, n_logical)))
        emit(row)
        del x, got, want
    # -- bwma_transpose at BERT-base K shapes: 512 x 64 per head
    k_rw = torch.randn(4, 12, S, 64, generator=gen, device=gen.device).to("cuda")
    for block in (16, 128):
        for dtype in (torch.float32, torch.bfloat16):
            x = to_blockwise(k_rw, BlockLayout(block, block)).to(dtype).contiguous()
            got = bwma_transpose(x)
            want = transpose_plain(x)
            torch.cuda.synchronize()
            name = str(dtype).split(".")[-1]
            plan = transpose_plan(*x.shape[-4:], x.element_size(), math.prod(x.shape[:-4]))
            row = {"phase": "mla_kernels", "kernel": "bwma_transpose", "block": block,
                   "dtype": name, "shape": list(x.shape), "max_abs_err": 0.0,
                   "word": plan.word, "tile_blocks": plan.tile_blocks,
                   "tile": [plan.tile_rows, plan.tile_cols], "ctas": plan.ctas}
            if not torch.equal(got, want):
                emit(row)
                raise AssertionError(f"bwma_transpose block {block} {name}: not bit-exact")
            lib_k = k_rw.to(dtype)
            b_ms, kind = bound_ms(2 * nbytes(x), 0.0)
            row.update(ms=time_ms(lambda: bwma_transpose(x)),
                       plain_ms=time_ms(lambda: transpose_plain(x)),
                       library_ms=time_ms(lambda: lib_k.transpose(-1, -2).contiguous()),
                       bound_ms=b_ms, bound_by=kind,
                       work=f"BERT-base K, 4 x 12 heads of {S} x 64, block {block}, {name}",
                       **device_and_host("bwma_transpose", lambda: bwma_transpose(x),
                                         lambda: lib_k.transpose(-1, -2).contiguous()))
            if block == 16 and dtype == torch.float32:
                out["bwma_transpose"] = row
            emit(row)
            del x, got, want, lib_k
    del k_rw
    torch.cuda.empty_cache()
    return out


def blocked_ops_path(torch, gen, kernels) -> dict:
    """The paper's unfused attention through the ``"cuda"`` Backend protocol
    -- softmax(q @ transpose(k) * scale) @ v with each step a backend op and
    the softmax through ``ops.blocked_softmax`` -- at BERT-base, block 16,
    batch 4, counts set to 0 just before and read just after.  Held against
    the fused attention kernel and the reference backend."""
    from repro_torch.core import blockwise as bw
    from repro_torch.core.backend import resolve_backend
    from repro_torch.core.layout import BlockLayout
    from repro_torch.kernels import ops

    be, ref = resolve_backend("cuda"), resolve_backend("reference")
    lo = BlockLayout(16, 16)
    q, k, v = (bw.block(torch.randn(4, 12, 512, 64, generator=gen, device=gen.device)
                        .to("cuda"), lo) for _ in range(3))
    scale = 64 ** -0.5

    def unfused(b, softmax):
        return b.matmul(softmax(b.scale(b.matmul(q, b.transpose(k)), scale)), v)

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    got = unfused(be, ops.blocked_softmax)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = unfused(ref, ref.softmax).unblock()
    fused = be.attention(q, k, v, scale=scale).unblock()
    got = got.unblock()
    err_ref = (got - want).abs().max().item() / want.abs().max().item()
    err_fused = (got - fused).abs().max().item() / fused.abs().max().item()
    row = {"phase": "blocked_ops", "work": "unfused attention, BERT-base, block 16, batch 4",
           "launches": counts, "rel_err_vs_reference": err_ref, "rel_err_vs_fused": err_fused,
           "ms": time_ms(lambda: unfused(be, ops.blocked_softmax), samples=10, inner=2)}
    emit(row)
    want_counts = {"bwma_transpose": 1, "bwma_softmax": 1, "bwma_gemm": 2}
    if {k: n for k, n in counts.items() if n} != want_counts:
        raise AssertionError(f"blocked-ops path launches {counts}, want {want_counts}")
    if not (err_ref <= KERNEL_RTOL and err_fused <= KERNEL_RTOL):
        raise AssertionError(f"blocked-ops path disagrees: {err_ref}, {err_fused}")
    del q, k, v
    torch.cuda.empty_cache()
    return counts


def mla_serve_phase(torch, kernels):
    """DeepSeek-V3's dense prefix at full width through the continuous engine."""
    import dataclasses

    import repro_torch.configs as C
    from repro_torch.models import model as M

    max_new = 64
    dense = dict(n_layers=3, family="dense", n_experts=0, n_shared_experts=0, top_k=0,
                 moe_d_ff=0, first_k_dense=0, mtp_depth=0)
    cfg = dataclasses.replace(C.get_config("deepseek-v3-671b", dtype=torch.float32), **dense)
    prompts, arrivals = serve_traffic(cfg.vocab_size)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = M.init_params(cfg, gen, device="cuda")
    counts = gated_serve(torch, kernels, cfg, params, prompts, arrivals, max_new,
                         "mla_paged_attention_decode")
    del params
    torch.cuda.empty_cache()
    cfg16 = dataclasses.replace(C.get_config("deepseek-v3-671b"), **dense)
    params = M.init_params(cfg16, gen, device="cuda")
    emit(timed_serve(torch, cfg16, params, prompts, arrivals, max_new))
    del params
    torch.cuda.empty_cache()
    return counts


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        raise SystemExit(f"chip_smoke.py: no src/repro_torch beside {__file__}; "
                         "run it from a checkout of the repository")
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: CUDA is not available; this script needs the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import repro_torch.kernels as kernels
    from repro_torch.kernels import _build

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "capability": list(torch.cuda.get_device_capability(0)),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # 2. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(lib_path.relative_to(ROOT)) if lib_path.is_relative_to(ROOT)
          else str(lib_path)})

    gen = torch.Generator(device="cpu").manual_seed(0)

    # 3. kernels against their plain versions
    summary = kernel_phase(torch, gen)
    attention_phase(torch, gen)
    layernorm_phase(torch, gen)
    emit({"phase": "kernels", "names": list(LAUNCHES_PER_FORWARD),
          "launches_during_checks": kernels.launch_counts()})

    # 4. the encoder path end to end
    counted = encoder_phase(torch, gen, kernels)

    # 5. the serving kernels against their plain versions
    serving = serving_kernel_phase(torch, gen)
    bf16_dense_check(torch, gen, kernels)
    emit({"phase": "serving_kernels", "names": list(SERVING_KERNELS),
          "launches_during_checks": kernels.launch_counts()})

    # 6. the serving path end to end
    served = serve_phase(torch, kernels)
    counted.update(paged_attention_decode=served["launches"]["paged_attention_decode"],
                   paged_copy=served["launches"]["paged_copy"],
                   rwma_gemm=served["rwma_launches"])

    # 7. the MLA decode, softmax and transpose kernels, and the blocked-ops path
    mla = mla_kernel_phase(torch, gen)
    emit({"phase": "mla_kernels", "names": list(MLA_KERNELS),
          "launches_during_checks": kernels.launch_counts()})
    blocked = blocked_ops_path(torch, gen, kernels)
    counted.update(bwma_softmax=blocked["bwma_softmax"],
                   bwma_transpose=blocked["bwma_transpose"])

    # 8. MLA serving end to end
    mla_counts = mla_serve_phase(torch, kernels)
    counted["mla_paged_attention_decode"] = mla_counts["mla_paged_attention_decode"]
    serving.update(mla)

    line = []
    for kernel in LAUNCHES_PER_FORWARD:
        row = summary[kernel]["bert-base block 16"]
        per = row["per_layer"]
        line.append({
            "name": kernel, "route": "cuda", "source": SOURCES[kernel],
            "replaces": REPLACES[kernel], "launches": counted[kernel],
            "max_abs_err": max(r["max_abs_err"] for r in summary[kernel].values()),
            "ms": per["ms"], "plain_ms": per["plain_ms"], "bound_ms": per["bound_ms"],
            "bound_by": per["bound_by"], "library_ms": per["library_ms"],
            "device_ms": per["device_ms"], "host_us": per["host_us"],
            "library_device_ms": per["library_device_ms"],
            "work": "one encoder layer's launches, BERT-base block 16, batch 4",
            "block_128": summary[kernel]["bert-base block 128"]["per_layer"],
        })
        if not all(math.isfinite(per[k]) for k in ("ms", "plain_ms", "bound_ms")):
            raise AssertionError(f"{kernel}: timing not finite")
    for kernel in SERVING_KERNELS + MLA_KERNELS:
        row = serving[kernel]
        line.append({
            "name": kernel, "route": "cuda", "source": SOURCES[kernel],
            "replaces": REPLACES[kernel], "launches": counted[kernel],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "device_ms": row["device_ms"],
            "host_us": row["host_us"], "library_device_ms": row["library_device_ms"],
            "work": row["work"],
        })
        if not all(math.isfinite(row[k]) for k in ("ms", "plain_ms", "bound_ms")):
            raise AssertionError(f"{kernel}: timing not finite")
    emit({"kernels": line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
