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
   never calls it) and the least time the card could take (H100 SXM spec).
4. encoder -- the 12-layer BERT-base encoder, blocks 16 and 128, on a batch
   of 4 sequences of 512 and on one unbatched sequence, through the
   ``"cuda"`` backend, held against the ``"reference"`` backend and
   ``encoder_rwma``; the kernels' launch counts per forward must be exactly
   60 bwma_gemm, 12 bwma_fused_ffn, 24 bwma_layernorm, 12 bwma_attention;
   the forward is timed and profiled (device time by kernel, idle share).

Then the per-kernel summary line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Any failure raises: the exit code is then
not 0 and the last line is not printed.  Imports only ``repro_torch``,
torch, numpy and the standard library.
"""
from __future__ import annotations

import json
import math
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
REPLACES = {
    "bwma_gemm": "src/repro/kernels/bwma_gemm.py:26",
    "bwma_fused_ffn": "src/repro/kernels/bwma_fused_ffn.py:21",
    "bwma_layernorm": "src/repro/kernels/bwma_layernorm.py:18",
    "bwma_attention": "src/repro/kernels/bwma_attention.py:36",
}
SOURCES = {
    "bwma_gemm": "src/repro_torch/kernels/csrc/bwma_gemm.cu",
    "bwma_fused_ffn": "src/repro_torch/kernels/csrc/bwma_gemm.cu",
    "bwma_layernorm": "src/repro_torch/kernels/csrc/bwma_layernorm.cu",
    "bwma_attention": "src/repro_torch/kernels/csrc/bwma_attention.cu",
}


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(n_bytes: float, flops: float) -> tuple:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
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
    from repro_torch.kernels.bwma_gemm import bwma_gemm, gemm_plain
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

    def gemm_case(label, a, b, lib_a, lib_b):
        return dict(label=label, call=lambda: bwma_gemm(a, b), plain=lambda: gemm_plain(a, b),
                    library=lambda: torch.matmul(lib_a, lib_b), in_bytes=nbytes(a, b),
                    flops=gemm_flops(a, b), crop=None)

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
                   "bytes_ms": 0.0, "ops_ms": 0.0}
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
                    library = c["library"]
                    case["library_ms"] = time_ms(library) if library else None
                    for key in ("ms", "plain_ms", "bound_ms"):
                        tot[key] += case[key]
                    tot["bytes_ms"] += n_bytes / PEAK_BYTES_PER_S * 1e3
                    tot["ops_ms"] += c["flops"] / PEAK_FP32_FLOPS * 1e3
                    if library:
                        tot["library_ms"] += case["library_ms"]
                    else:
                        has_library = False
                del out, want
                row["cases"].append(case)
            row["max_abs_err"] = worst
            if timed:
                row["per_layer"] = {k: tot[k] for k in ("ms", "plain_ms", "bound_ms")}
                row["per_layer"]["library_ms"] = tot["library_ms"] if has_library else None
                row["per_layer"]["bound_by"] = (
                    "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations")
            emit(row)
            summary.setdefault(kernel, {})[cfg_name] = row
        del cases
        torch.cuda.empty_cache()
    return summary


def profile_forward(torch, forward) -> dict:
    """One forward under torch.profiler: the device time by kernel, the
    device window (first kernel start to last kernel end) and the share of
    it in which no kernel ran."""
    from torch.profiler import ProfilerActivity, profile

    forward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        forward()
        torch.cuda.synchronize()
    by_kernel, spans = {}, []
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((evt.time_range.start, evt.time_range.end))
        name = evt.name
        if "bwma_gemm_kernel" in name:
            key = "bwma_fused_ffn" if "true>" in name else "bwma_gemm"
        else:
            key = next((k for k in LAUNCHES_PER_FORWARD if f"{k}_kernel" in name), "other")
        by_kernel[key] = by_kernel.get(key, 0.0) + (evt.time_range.end - evt.time_range.start) / 1e3
    if not spans:
        return {"profile": "no device events recorded"}
    window = (max(e for _, e in spans) - min(s for s, _ in spans)) / 1e3
    busy = sum(by_kernel.values())
    return {"device_window_ms": window, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / window, "device_ms_by_kernel": by_kernel}


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

    # 3. kernels against their plain versions
    gen = torch.Generator(device="cpu").manual_seed(0)
    summary = kernel_phase(torch, gen)
    emit({"phase": "kernels", "names": list(LAUNCHES_PER_FORWARD),
          "launches_during_checks": kernels.launch_counts()})

    # 4. the main path end to end
    counted = encoder_phase(torch, gen, kernels)

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
            "work": "one encoder layer's launches, BERT-base block 16, batch 4",
        })
        if not all(math.isfinite(per[k]) for k in ("ms", "plain_ms", "bound_ms")):
            raise AssertionError(f"{kernel}: timing not finite")
    emit({"kernels": line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
