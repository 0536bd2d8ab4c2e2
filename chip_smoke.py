#!/usr/bin/env python3
# repro: noqa-file RPR004 -- the smoke script picks each model's decode kernel and checks by family
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
   per call with no synchronise between calls (``host_us``).  Where five
   profiler sessions in a row record no event of the kernel, its CUDA-event
   time per launch stands in (``device_ms_from``), and a line before the
   kernels line counts the sessions, the empty ones and these fallbacks.
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
   tokens/s, TTFT (cold: a fresh engine's run, each chunk shape's first use
   and capture included; and on that engine, its shapes met, the same
   traffic with other tokens), the device time by kernel of one profiled
   engine step of four full chunks and of one profiled decode step, and the
   device's idle share.
7. mla kernels -- mla_paged_attention_decode at DeepSeek-V3 decode shapes
   (B=4, 128 heads, latent 512, rope 64, pages of 128, seq_pos
   0/127/1000/1900, a scattered page table with unmapped entries on the null
   page; fp32 and bf16 pools; each slot's output also bit-identical alone,
   behind null-page columns and run to run; the plan -- split keys, splits,
   live CTAs -- and ptxas's registers and spills of its split and combine
   kernels on earlier lines; its device time is the two kernels'),
   bwma_softmax at BERT-base attention-score
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
9. moe serve -- granite-moe-3b-a800m at full width (8 of its 32 layers,
   ``CUT_DEPTH``; d_model 1536, 24 heads over 8 kv heads, 40 experts
   top-8, vocab 49155) on the traffic of phase 6 with one-shot prefill (each prompt dispatched as the
   group ``Server.generate`` uses).  Gates, in fp32: greedy tokens equal
   ``Server.generate`` where the margin rule or the router rule excuses no
   divergence (the rule: the baseline's top-2 logit margin below 1e-3 at
   the divergence, or some MoE layer at a decode step up to it with its
   k-th and (k+1)-th router probabilities within 1e-6 on the baseline's
   path; the count each rule excused is printed, with step, layer and gap);
   paged_attention_decode launches == layers x decode steps; paged_copy ==
   2 x COW copies (sharing is off under one-shot prefill); no other kernel; a
   clean audit; a ``"reference"`` run launches nothing.  Timed in bf16 with
   128-token chunks, as phase 6.  Then DeepSeek-V3 cut to 4 layers, its 3
   dense ones and one MoE layer at full width (256 routed experts top-8 and
   a shared one), bf16 only: one-shot prefill, each request's first token
   equal to ``Server.generate``'s, mla_paged_attention_decode launches == 4
   x decode steps and no other kernel, finite logits, a clean audit; then
   timed as phase 6.
10. swa serve -- h2o-danube-3-4b at full width (8 of its 24 layers,
   ``CUT_DEPTH``; d_model 3840, 32 heads over 8 kv heads of 120, window
   4096): 3 requests of 4200-4600 prompt tokens (the ring wraps), 16 new
   tokens, max_len 8192, chunks of 128.  Gates, in fp32: greedy tokens under the margin rule, no kernel
   launched (the ring path runs none), a clean audit.  Timed in bf16 on the
   traffic of phase 6.
11. ssm serve -- mamba2-130m at full width (24 layers, d_model 768, SSM
   state 128, 24 heads of 64, vocab 50280), then hymba-1.5b (8 of its 32
   layers, ``CUT_DEPTH``; d_model 1600, 25 heads over 5 kv heads with a
   window of 1024 beside 50 SSM heads of 64, d_ff 5504), each on the traffic of phase 6 (prompt 0
   of 1200 tokens passes Hymba's window) with 128-token chunks on the SSD
   chunk grid.  Gates, in fp32: greedy tokens under the margin rule, no
   kernel launched (the SSM path runs none), no prompt token served from a
   cache (sharing is off), a clean audit.  Then timed in bf16.
12. encdec serve -- whisper-tiny at full width (4 encoder + 4 decoder
   layers, 1500 audio frames, d_model 384, 6 heads of 64) on the traffic
   of phase 6 with prompt 2 equal to prompt 0's tokens; each request
   brings its own (1, 1500, 384) audio embedding from a numpy seed.
   Gates, in fp32: paged_attention_decode launches == 4 x decode steps, no
   paged_copy, no prompt token served from a cache, greedy tokens equal
   ``Server.generate`` with the same audio under the margin rule, a clean
   audit, a ``"reference"`` run launches nothing.  Then timed in bf16.
13. vision serve -- qwen2-vl-72b at full width (d_model 8192, 64 heads
   over 8 kv heads, d_ff 29568, vocab 152064, M-RoPE sections 16/24/24),
   cut to 4 of its 80 layers, through the static ``Server`` (the engine
   has no cache adapter for it, in the JAX package as here): a wave of 4
   requests, each a (1, 1024, 8192) image from a numpy seed over its first
   1024 tokens and 256 text tokens after it, on Qwen2-VL's grid positions
   (three different streams), 64 new tokens.  Gates, in fp32: the wave's
   greedy tokens equal each request's own ``Server.generate`` under the
   margin rule; two requests with the same tokens and other images differ
   in their first logits, and the grid streams differ from equal streams,
   each by at least 1e-3; no kernel launched.  Timed in bf16 through the
   ``Server`` (its prefill and decode graphs): the wave generated three
   times, each prefill and decode step timed, decode step median and p90,
   decode tok/s, one profiled step.
14. train -- minicpm-2b at full width cut to 2 layers, fp32, batch 2 x
   128: ``loss_fn`` and its gradients on the card against the same call on
   the CPU (loss within 1e-5 relative, each gradient leaf within 1e-4 of
   its max |g|), then 3 AdamW steps on each (parameters within 1e-5,
   except elements whose gradient lay within that 1e-4 of zero, which move
   by at most 2.5 x the summed learning rates); no kernel launched;
   ``gemm_backend="bwma"`` refuses autograd.  Then minicpm-2b at full
   width and depth (40 layers) in bf16 with fp32 moments, batch 4 x 512,
   WSD, through ``Trainer.fit``: 30 uninterrupted steps (every loss
   finite, the mean of the last 5 at least ``LOSS_DROP`` below step 0;
   step ms median and p90, tokens/s, peak memory, one profiled step, the
   share of the bf16 peak by 6 x parameters x tokens), then 20 steps that
   end in a checkpoint, which restores bit for bit, and 10 steps resumed
   from it by the trainer's restore and step (one checkpoint of 27 GB: a
   call may write 45 GiB to the machine's disk), each loss within
   ``RESUME_RTOL`` of the uninterrupted run's.
15. tp serve -- tensor-parallel serving on a 1 x 2 mesh: the kernel
   library built above, two spawned ranks, rank ``r`` on ``cuda:(r %
   device_count)``, NCCL with a card a rank, else gloo (the ranks then share
   the card); a timeout on every collective and on the ranks' whole run.
   First, on each rank, one launch of paged_attention_decode (starcoder2-7b's
   decode shape: 18 of 36 heads over 2 of 4 kv heads), of
   mla_paged_attention_decode (DeepSeek-V3's: 64 of 128 heads, whole latent
   pools) and of paged_copy (the rank's pool slice), fp32 and bf16, each
   equal bit for bit to the head slice of the launch on every head.  Then
   three fp32 runs, each against the single-device engine on the same
   weights (seed 0) and traffic (8 prompts of 64-512 tokens, prompt 2 the
   first 300 tokens of prompt 0, 16 new tokens, 4 slots, pages and chunks of
   128), the single-device tokens computed first and freed before the
   spawn: starcoder2-7b at full width, 8 of its 32 layers (``CUT_DEPTH``;
   the ranks take turns drawing the full tree, each keeping half),
   DeepSeek-V3's dense prefix (3 layers, 64 heads a rank) and granite
   (8 layers, ``CUT_DEPTH``; 20 of its 40 experts a rank, one-shot prefill).
   Gates: tokens the same on both ranks and equal to the single-device
   engine's under the margin rule (and the router rule for granite);
   each rank's decode-kernel and paged_copy launches equal to the
   single-device run's, one decode launch per layer and step; each rank's
   pool bytes half of the single-device pool's (head-sharded GQA pools) or
   all of it (MLA latent pools); every MLA decode call of the run within
   1e-6 of its plain version.  Then starcoder2-7b's bf16 decode step (all
   32 layers) median and p90 on the two ranks, labelled by how many cards they share:
   no tensor-parallel speed-up is claimed.
16. tp train -- training on a data x model mesh: minicpm-2b at full width
   cut to 4 layers (527,010,048 parameters, above ``REPLICATE_BELOW``, so
   the train-mode specs shard with no patch), fp32, batch 2 x 128, 3 steps
   at a constant learning rate, from one initial state (seed 0, drawn by
   shards on the ranks), first on one device (``Trainer`` on the card),
   then by two spawned ranks (as in phase 15) on a ``2 x 1`` mesh (DP +
   ZeRO) and on a ``1 x 2`` mesh (TP).  Gates: every rank's losses the same
   and within 1e-5 relative of the single device's; the parameters,
   gathered, within phase 14's fp32 AdamW gate of the single device's;
   each rank's parameter and moment bytes exactly its specs' share; the
   ``2 x 1`` run's checkpoint restored on one device bit for bit equal to
   its gathered state; no kernel launched.  Printed: each rank's resident
   bytes and ``max_memory_allocated``, and its step ms labelled "2 ranks
   on one card (gloo)" where they share it -- not a DP or TP speed.
17. dp serve -- serving on a data x model mesh: four spawned ranks on a
   ``2 x 2`` mesh, placed as in phase 15 (gloo where they share a card:
   "4 ranks on one card (gloo)").  Each rank first runs phase 15's kernel
   head-slice checks on its model slice (the pools sit on a model axis of
   2, as there; phase 15's checks against the plain versions at those
   per-rank shapes stand for this phase), then draws its shares of the JAX
   serve mode's resident weights from seed 0 by shards
   (``ServeLayout``; no rank holds the full tree) for three fp32 runs on
   phase 15's traffic, each against the single-device engine on the same
   weights, computed first: starcoder2-7b at full width, 8 of its 32
   layers, ``CUT_DEPTH`` (weights split over all four ranks; pools over the model axis,
   18 of 36 heads over 2 of 4 kv heads a rank), DeepSeek-V3's dense prefix
   (MLA, 64 of 128 heads a model slice) and granite (8 layers, 10 of its
   40 experts a rank, one-shot prefill).  Gates: tokens the same on every
   rank and equal to the single-device engine's under the margin rule (and
   the router rule for granite); each rank's launches exact
   (paged_attention_decode and mla_paged_attention_decode one per layer
   and decode step, paged_copy 2 per COW copy and as on one device, no
   other kernel); each rank's parameter bytes exactly the serve spec's
   share plus its kept-whole leaves, its peak while loading below the full
   tree and within its shares plus one full leaf or layer; pool bytes as
   in phase 15; every MLA decode call within 1e-6 of its plain version.
   Printed: each rank's ``max_memory_allocated`` beside its prediction,
   its load and run seconds and steps per second.
18. memmodel -- the paper's trace-driven memory model
   (``repro_torch.core.memmodel``) on the card: every ``MemStats`` field of
   every component equal to the same model's CPU run at the reduced layer
   (seq 128, d 192, 3 heads, d_ff 768) for the three accelerators, both
   layouts and 1, 2, 4 cores, and at the full BERT-base layer for SA16x16
   (both layouts, one core); then the full-size Fig. 6a (three
   accelerators), Fig. 6b (SA16x16 at 1, 2, 4 cores), Fig. 7 (GEMM share),
   Fig. 8 (L1 misses, L2 and DRAM accesses, address cycles) and §3.2
   conversion figures, with the model's seconds on the card; SA16x16's
   single-core speedup within the JAX test's 1.8-3.8 band.
19. dryrun -- ``repro_torch.launch.dryrun`` on one device: mamba2-130m's
   decode_32k and prefill_32k cells traced on the meta device, then the
   same steps run once on the card with real tensors (bf16, weights from a
   seed; prefill at the rows whose predicted peak fits half the card, the
   full cell's prediction printed beside).  Gates: the dry run's argument
   bytes equal the real inputs' bytes, its FLOPs equal FlopCounterMode's
   on the real run, no collective, finite logits.  Printed: the predicted
   peak (arguments + temporaries) beside ``max_memory_allocated``.
20. analysis -- ``repro_torch.analysis.torchcheck`` on the card: (a) the
   engine's step inventory at the checked-in geometry (minicpm-2b smoke,
   fp32, 2 slots, max_len 64, page 8), the kernel route included, with no
   finding against ``torchcheck.budgets``; ``decode_step`` and ``cow_copy``
   must launch their kernels and the reference twins none, and every
   step's argument, output, gather and in-place bytes equal the budgets'.
   (b) The same builder at minicpm-2b's full width (d_model 2304, 40
   layers, vocab 122,753, fp32, 2 slots): RPJ101, RPJ103 and RPJ104 clean
   (no conversion wider than fp32 but the budgets' allowed widenings to
   torch's int64 index dtype), the
   decode step's largest gather the two slots' embedding rows (2 x 2304 x
   4 B); printed: each step's traced bytes beside ``max_memory_allocated``
   above its arguments.  (c) A full-width minicpm-2b engine serving three
   requests (chunked prefill, 16 new tokens each) with its decode and chunk
   steps under ``torch.cuda.set_sync_debug_mode("error")``: tokens
   bit-identical to an unguarded engine's, every guarded call counted.
   (d) Each rank of a ``1 x 2`` serve mesh places smoke weights drawn on
   ``cuda:0`` onto ``cuda``: every placed leaf owns its storage (no view
   keeping the full leaf alive).
21. graph -- the serving steps as CUDA graphs (``serve/graphs.py``; every
   single-card engine of phases 6-12 and 20 already replays its decode step
   and chunk steps, and every single-rank ``Server`` its prefill and
   decode, so their gates hold the graphed engine against the graphed
   ``Server.generate``).  In fp32 at each served
   family's decode shape -- starcoder2-7b (8 layers), DeepSeek-V3's dense
   prefix, granite (8), h2o (8), mamba2-130m, hymba (8), whisper-tiny --
   five requests just under a page boundary, one the prefix of another, 16
   new tokens each, 4 slots on 5 usable pages of 128 (admission,
   copy-on-write where the family shares tail pages, preemption, refill).
   Gates: (a) every replay's greedy tokens and logits on the active slots
   and every pool leaf but the null page bit-identical to the eager decode
   step on a clone of the pool and a copy of the runner's inputs; (b) one
   capture an engine, the decode kernel recorded once a layer, no buffer,
   pool leaf or page-table mirror moved; (c) every replay under
   ``torch.cuda.set_sync_debug_mode("error")``; starcoder2-7b also runs a
   2-slot engine in turns with the 4-slot one (the larger workspaces
   captured second).  (d) In a child process, a decode step with an
   injected ``.item()`` makes the capture raise right after the warm-up.
   (e) Printed: each capture's seconds and private-pool bytes.  (f) The
   chunk graphs (one a chunk shape, captured at its first use, sharing an
   engine's pool) of the same engines: every chunk's replay under the sync
   guard, its logits and every pool leaf but the null page bit-identical to
   the eager chunk step on a clone of the pool and copies of the runner's
   inputs; one capture a shape, the shapes those of the chunks run and
   within ``chunk_shape_set``; no buffer, pool leaf or mirror moved; after
   the run each runner replayed again in the reverse of its capture order,
   bit-identical to the eager step (null page included); a chunk step with
   an injected ``.item()`` makes the capture raise (a child process).  (g)
   The static ``Server``'s graphs in fp32, starcoder2-7b (8 layers) and
   qwen2-vl-72b (4 layers): waves of 2, 1 and 2 requests, 8 new tokens;
   every prefill and decode replay under the sync guard and bit-identical
   to the eager step (logits and caches), one prefill capture a prompt
   shape and one decode capture a batch size, each batch size's cache tree
   kept, the third wave's tokens equal to the first's.

Each phase's seconds follow it on a line of their own.  Then the per-kernel
summary line (the decode kernels' and the page copy's launches per serving
run under ``launches_by_run``), the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Any failure raises: the exit code is then
not 0 and the last line is not printed.  Imports only ``repro_torch``,
torch, numpy and the standard library.
"""
from __future__ import annotations

import json
import math
import os
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
# at a step where the baseline's top-2 logit margin is below this, or, in a
# MoE stack, after a decode step of the baseline's path where some MoE
# layer's k-th and (k+1)-th router probabilities lay within ROUTER_GAP (a
# near-tie that the engine's 4-slot products may resolve the other way).
MARGIN = 1e-3
ROUTER_GAP = 1e-6


# paged_attention_decode's decode shapes (B, H, Hkv, dh, page, maxp) on the
# serving paths: four slots at the ragged positions below (whisper's within
# its 448-token context), maxp from each run's max_len
STARCODER_DECODE = (4, 36, 4, 128, 128, 16)
GRANITE_DECODE = (4, 24, 8, 64, 128, 16)
WHISPER_DECODE = (4, 6, 6, 64, 128, 4)
DECODE_SEQ = [0, 127, 1000, 1900]
WHISPER_SEQ = [0, 127, 300, 447]
# whisper's decoder context (n_text_ctx of the published checkpoints): its
# serving runs hold prompt plus generated tokens within it
WHISPER_CONTEXT = 448
# the script's time limit stays while it grows: these serving runs, the
# slowest on the host, keep their full width and 8 of their layers
CUT_DEPTH = {"granite-moe-3b-a800m": 8, "h2o-danube-3-4b": 8, "hymba-1.5b": 8,
             "starcoder2-7b": 8}  # starcoder2-7b: phases 15 and 17's fp32 runs


def paged_decode_case(torch, gen, shape, seq, dtype, label):
    """paged_attention_decode against decode_plain at one decode shape
    ``(B, H, Hkv, dh, page, maxp)``, its slots at positions ``seq`` on a
    scattered page table (unmapped entries on the null page): within
    PAGED_TOL for fp32 pools, one bf16 rounding plus PAGED_TOL for bf16;
    each slot batch invariant (alone, and behind maxp doubled by null-page
    columns), and the call bit-identical run to run.  Raises on a failure;
    returns the operands and the max abs error."""
    import numpy as np

    from repro_torch.kernels.paged_attention import decode_plain, paged_attention_decode

    B, H, hkv, dh, page, maxp = shape
    num_pages = B * maxp + 1
    rng = np.random.default_rng(0)
    table = np.zeros((B, maxp), np.int32)
    phys = rng.permutation(np.arange(1, num_pages))
    for b, pos in enumerate(seq):
        used = pos // page + 1
        table[b, :used] = phys[b * maxp:b * maxp + used]  # unmapped: the null page
    table_t = torch.from_numpy(table).to("cuda")
    seq_t = torch.tensor(seq, dtype=torch.int32, device="cuda")
    q = torch.randn(B, 1, H, dh, generator=gen, device=gen.device).to("cuda", dtype)
    kp = torch.randn(num_pages, page, hkv, dh, generator=gen, device=gen.device).to(
        "cuda", dtype)
    vp = torch.randn(num_pages, page, hkv, dh, generator=gen, device=gen.device).to(
        "cuda", dtype)
    args = (q, kp, vp, table_t, seq_t)
    what = f"paged_attention_decode {label} {shape} {dtype}"
    got = paged_attention_decode(*args).float()
    want = decode_plain(*args).float()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    ok = err <= PAGED_TOL if dtype == torch.float32 else bool(
        torch.all((got - want).abs() <= BF16_ROUNDING * want.abs() + PAGED_TOL))
    if not ok:
        raise AssertionError(f"{what}: max err {err}")
    full = paged_attention_decode(*args)
    wide = paged_attention_decode(q, kp, vp, torch.cat([table_t, torch.zeros_like(table_t)], 1),
                                  seq_t)
    for b in range(B):
        alone = paged_attention_decode(q[b:b + 1], kp, vp, table_t[b:b + 1], seq_t[b:b + 1])
        if not (torch.equal(alone[0], full[b]) and torch.equal(wide[b], full[b])):
            raise AssertionError(f"{what}: slot {b} is not batch invariant")
    if not torch.equal(paged_attention_decode(*args), full):
        raise AssertionError(f"{what}: not bit-identical run to run")
    return args, err


def paged_decode_checks(torch, shape, seq, label) -> dict:
    """:func:`paged_decode_case` in fp32 and bf16 at a serving run's decode
    shape, one line each.  Returns {dtype: max abs error}."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        _, errs[name] = paged_decode_case(torch, gen, shape, seq, dtype, label)
        emit({"phase": "serve", "model": label, "kernel": "paged_attention_decode",
              "check": "against decode_plain, batch invariant, bit-identical run to run",
              "shape": list(shape), "seq_pos": seq, "dtype": name,
              "max_abs_err": errs[name]})
    return errs


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
FOLLOW_UP_KERNELS = ("paged_decode_combine_kernel", "mla_decode_combine_kernel")


# What the profiler missed: each session that recorded no event of the
# kernel it was asked for, and each time the CUDA events had to stand in
# (main prints both on a line of their own).
PROFILER_MISSES = {"sessions": 0, "empty_sessions": 0, "fallbacks": []}


def device_profile(fn, calls: int = 20, want: str = "all", sessions: int = 5):
    """``calls`` calls of ``fn`` under torch.profiler, after a warm-up:
    ``{key: (device ms, launches)}`` with the port's kernels by name
    (:func:`kernel_of`; a follow-up kernel's time counts, its event is not a
    launch), ``"follow-up"`` for the follow-up kernels alone and ``"all"``
    for every device event.  A session that records no ``want`` event is
    run again, up to ``sessions`` sessions: the profiler sometimes returns
    one without the device events of work that ran.  None if every session
    missed it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        PROFILER_MISSES["sessions"] += 1
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
        PROFILER_MISSES["empty_sessions"] += 1
        time.sleep(0.1)
    return None


def call_device_ms(fn, calls: int = 20, what: str = "a call") -> float:
    """The device time per call of ``fn``, every kernel and copy it runs;
    from CUDA events where the profiler recorded no device event."""
    by = device_profile(fn, calls)
    if by is None:
        PROFILER_MISSES["fallbacks"].append(what)
        return time_ms(fn)
    return by["all"][0] / calls


def device_and_host(kernel: str, call, library=None) -> dict:
    """A kernel row's device ms per launch of the port's ``kernel`` inside
    ``call``, from the profiler: the kernel's own duration (with its
    follow-up kernels', also given alone where it has any), without the
    host's time between launches that the CUDA-event times of a short
    kernel include; its wrapper's host µs per call; and the library call's
    device ms per call (None without one).  ``device_ms_from`` says where
    the device times came from: where the profiler recorded no event of the
    kernel, the CUDA-event time per launch stands in for them."""
    from repro_torch.kernels import launch_counts

    by = device_profile(call, want=kernel)
    if by is None:
        PROFILER_MISSES["fallbacks"].append(kernel)
        before = launch_counts()[kernel]
        call()
        n = launch_counts()[kernel] - before
        row = {"device_ms": time_ms(call) / n, "device_ms_from": "cuda events"}
    else:
        t, n = by[kernel]
        row = {"device_ms": t / n, "device_ms_from": "profiler"}
        if "follow-up" in by:
            row["follow_up_device_ms"] = by["follow-up"][0] / n
    row.update(host_us=host_us(call), library_device_ms=None if library is None
               else call_device_ms(library, what=f"{kernel}'s library call"))
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
                froms = {c["device_ms_from"] for c in row["cases"]}
                row["per_layer"]["device_ms_from"] = " and ".join(sorted(froms))
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

            row.update(ms=time_ms(call16), call_device_ms=call_device_ms(call16, what="bf16 bwma_attention"),
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
                         ("mla_paged_attention_decode", "mla_decode_combine_kernel"),
                         ("bwma_softmax", "bwma_softmax_kernel"),
                         ("bwma_transpose", "bwma_transpose_kernel")):
        if pattern in name:
            return key
    return "other"


def csrc_constant(source: str, name: str) -> int:
    """A ``constexpr int`` of one of the port's CUDA sources."""
    text = (SRC / "repro_torch" / "kernels" / "csrc" / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def ptxas_usage(source: str, kernel: str) -> "subprocess.Popen":
    """Start ``nvcc -Xptxas -v`` on one of the port's CUDA sources with the
    build's flags; :func:`read_ptxas` reads each instantiation of ``kernel``
    from it."""
    from repro_torch.kernels import _build

    src = SRC / "repro_torch" / "kernels" / "csrc" / source
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src), "-o",
           "/dev/null"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    proc.kernel = kernel
    return proc


def read_ptxas(proc) -> dict:
    """``{mangled name: {"registers": n, "stack_frame": b, "spill_stores": b,
    "spill_loads": b}}`` for the kernel's instantiations, from
    :func:`ptxas_usage`'s output."""
    out, _ = proc.communicate(timeout=600)
    if proc.returncode:
        raise AssertionError(f"ptxas -v failed:\n{out[-2000:]}")
    usage, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1) if proc.kernel in m.group(1) else None
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if name and m:
            usage.setdefault(name, {}).update(stack_frame=int(m.group(1)),
                                              spill_stores=int(m.group(2)),
                                              spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if name and m:
            usage.setdefault(name, {})["registers"] = int(m.group(1))
    if not usage:
        raise AssertionError(f"ptxas -v printed nothing for {proc.kernel}")
    return usage


def port_kernel_names() -> set:
    """The name of every ``__global__`` function in the port's CUDA sources,
    read from the sources themselves, so that it does not lean on the
    patterns of :func:`kernel_of`."""
    kernel = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*)?"
                        r"(\w+)\s*\(")
    return {name for path in (SRC / "repro_torch" / "kernels" / "csrc").glob("*.cu*")
            for name in kernel.findall(path.read_text())}


def profile_forward(torch, forward, warm: bool = True) -> dict:
    """One call under torch.profiler (after one unprofiled call, with
    ``warm``): the device time by kernel (the port's kernels by name, the
    rest under "other", with its five largest names), the device window
    (first kernel start to last kernel end) and the share of it in which no
    kernel ran."""
    from torch.profiler import ProfilerActivity, profile

    if warm:
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
        froms = set()
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
            dh = device_and_host("rwma_gemm",
                                 lambda: rwma_gemm(a, w, bm=block, bk=block, bn=block),
                                 lambda: torch.matmul(a, w))
            for key in ("device_ms", "host_us", "library_device_ms"):
                tot[key] += dh[key]
            froms.add(dh["device_ms_from"])
            tiles[name] = list(rwma_route(M, k, n, block, block)[1])
            del a, w, got, want, ab, wb
        row = {"phase": "serving_kernels", "kernel": "rwma_gemm", "block": block,
               "max_abs_err": worst, "cta_tiles": tiles,
               "peak_share": ops_ms / tot["ms"], "bwma_peak_share": ops_ms / tot["bwma_ms"],
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "work": f"one BERT-base layer's six projections, M = 2048, block {block}",
               "device_ms_from": " and ".join(sorted(froms)), **tot}
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
    B, H, hkv, dh, page, maxp = shape = STARCODER_DECODE
    seq = DECODE_SEQ
    n_keys = sum(p + 1 for p in seq)
    num_pages = B * maxp + 1
    for dtype in (torch.float32, torch.bfloat16):
        args, err = paged_decode_case(torch, gen, shape, seq, dtype, "starcoder2-7b")
        q, kp, vp, table_t, seq_t = args
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
        del q, kp, vp, kg, vg, args
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


def margin_at(cfg, params, server, prompt, want, i, device="cuda", extras=None):
    """The baseline's top-2 logit margin at generated step ``i``, from
    stepping the port's ``model.prefill`` and ``model.decode_step`` along the
    baseline's own tokens, as ``Server.generate`` does.  Also returns the
    router gaps on that path: ``(step, layer, gap)`` for every MoE layer of
    every decode step ``1..i`` (the forward that produces token ``step``),
    ``gap`` the k-th minus the (k+1)-th router probability; none for a
    dense stack.  ``extras``: the request's modality inputs (an enc-dec
    config's audio), given to the prefill as ``Server.generate`` gives
    them."""
    import numpy as np
    import torch

    from repro_torch.models import ffn
    from repro_torch.models import model as M
    from repro_torch.serve.engine import bucket_tokens

    real = ffn.moe_forward
    at = {"step": 0, "layer": cfg.first_k_dense}
    gaps = []

    def recording(p, c, x):  # the router's probabilities, as moe_forward computes them
        if at["step"]:
            probs = torch.softmax(x.reshape(-1, x.shape[-1]).float() @ p["router"].float(), -1)
            top = torch.topk(probs, c.top_k + 1, -1).values
            gaps.append((at["step"], at["layer"], (top[:, -2] - top[:, -1]).min()))
            at["layer"] += 1
        return real(p, c, x)

    S = len(prompt)
    # the prompt shape Server.generate runs: bucketed where the family allows
    Sp = min(bucket_tokens(S, cfg.block), server.sc.max_len) \
        if M.supports_padded_prefill(cfg) else S
    padded = np.zeros((1, Sp), np.int32)
    padded[0, :S] = prompt
    ffn.moe_forward = recording
    try:
        batch = {"tokens": torch.from_numpy(padded).to(device),
                 **{k: torch.from_numpy(v).to(device) for k, v in (extras or {}).items()}}
        logits, caches = M.prefill(cfg, params, batch, S - 1)
        caches = server._grow_cache(caches, 1, S)
        for j in range(i):
            at.update(step=j + 1, layer=cfg.first_k_dense)
            tok = torch.tensor([[int(want[j])]], device=device)
            logits, caches = M.decode_step(cfg, params, caches, tok, S + j)
    finally:
        ffn.moe_forward = real
    top2 = torch.topk(logits[0, -1].float(), 2).values
    return (top2[0] - top2[1]).item(), [(s, l, float(g)) for s, l, g in gaps]


def agree(cfg, params, prompts, got, max_new, label, device="cuda", max_len=2048,
          extras=None):
    """Greedy tokens ``got`` against the single-request ``Server.generate``
    under the margin rule: a divergence at step ``i`` is excused where the
    baseline's top-2 logit margin there is below ``MARGIN``, or (a MoE
    stack) where some MoE layer at a decode step ``<= i`` of the baseline's
    own path had its k-th and (k+1)-th router probabilities within
    ``ROUTER_GAP``.  ``extras`` (one dict or None per prompt) are each
    request's modality inputs.  Returns the agreed prefix lengths and the
    excused divergences, each with its rule (and the near-ties: step,
    layer, gap)."""
    import numpy as np

    from repro_torch.serve import ServeConfig, Server

    server = Server(cfg, params, ServeConfig(max_len=max_len), device=device)
    agreed, excused = [], []
    for rid, prompt in enumerate(prompts):
        extra = extras[rid] if extras else None
        want = server.generate({"tokens": prompt[None], **(extra or {})}, max_new)[0]
        mine = np.asarray(got[rid])
        if np.array_equal(mine, want):
            agreed.append(len(want))
            continue
        i = int(np.argmax(mine != want))
        margin, gaps = margin_at(cfg, params, server, prompt, want, i, device, extra)
        agreed.append(i)
        near = [{"step": s, "layer": l, "gap": g} for s, l, g in gaps if g <= ROUTER_GAP]
        if margin < MARGIN:
            excused.append({"rid": rid, "step": i, "rule": "margin", "margin": margin})
        elif near:
            excused.append({"rid": rid, "step": i, "rule": "router", "margin": margin,
                            "near_ties": near})
        else:
            least = min(gaps, key=lambda t: t[2]) if gaps else None
            raise AssertionError(f"{label}: request {rid} diverges at step {i} where the "
                                 f"baseline's top-2 margin is {margin} >= {MARGIN} and no "
                                 f"router gap is <= {ROUTER_GAP} (least: {least})")
    return agreed, excused


def excused_counts(excused) -> dict:
    return {rule: sum(e["rule"] == rule for e in excused) for rule in ("margin", "router")}


def run_engine(cfg, params, prompts, arrivals, max_new, device="cuda", extras=None,
               **ec_kw):
    from repro_torch.serve import Engine, EngineConfig

    ec = {"max_seqs": 4, "max_len": 2048, "page_size": 128, "prefill_chunk": 128, **ec_kw}
    eng = Engine(cfg, params, EngineConfig(**ec), device=device)
    for rid, (p, t) in enumerate(zip(prompts, arrivals)):
        eng.submit(p, max_new, rid=rid, arrival_step=t,
                   extras=extras[rid] if extras else None)
    return eng


def drained_audit(eng):
    stats = eng.kv.audit()
    if stats.slot_held or eng.kv._pages:
        raise AssertionError(f"drained pool still has slot pages: {stats}")
    return stats


def gated_serve(torch, kernels, cfg, params, prompts, arrivals, max_new, decode_kernel,
                min_cow=1, extras=None, **ec_kw):
    """The fp32 gates of one model through the continuous engine with the
    ``"cuda"`` backend (engine settings ``ec_kw`` beyond ``run_engine``'s),
    counts set to 0 just before the run and read just after:
    ``decode_kernel`` launched once per layer and decode step (None: a
    family whose decode runs no kernel), paged_copy twice per COW copy (at
    least ``min_cow`` copies), no other kernel, a clean audit, no prompt
    token served from a prefix cache where sharing is off, and greedy
    tokens equal to ``Server.generate`` under the margin rule; then a
    ``"reference"`` run on three of the prompts launches no kernel.
    ``extras`` (one dict or None per prompt): each request's modality
    inputs.  Returns the launch counts of the gated run."""
    import dataclasses

    eng = run_engine(cfg, params, prompts, arrivals, max_new, backend="cuda", extras=extras,
                     **ec_kw)
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
    if decode_kernel is not None and counts[decode_kernel] != cfg.n_layers * eng.decode_steps:
        raise AssertionError(f"{decode_kernel} launched {counts[decode_kernel]} times, not "
                             f"{cfg.n_layers} x {eng.decode_steps} decode steps")
    if eng.kv.cow_copies < min_cow or counts["paged_copy"] != 2 * eng.kv.cow_copies:
        raise AssertionError(f"COW: {eng.kv.cow_copies} copies, paged_copy launched "
                             f"{counts['paged_copy']} times (want 2 per copy, "
                             f">= {min_cow} copies)")
    others = {k: n for k, n in counts.items() if n and k not in (decode_kernel, "paged_copy")}
    if others:
        raise AssertionError(f"the xla route launched other kernels: {others}")
    cached = [r.stats.cached_prompt_tokens for r in reqs]
    if not eng.kv.sharing and (any(cached) or eng.kv.pages_aliased):
        raise AssertionError(f"sharing is off, yet cached prompt tokens {cached}, "
                             f"{eng.kv.pages_aliased} pages aliased")
    agreed, excused = agree(cfg, params, prompts, got, max_new,
                            f"{cfg.name} fp32 engine vs Server.generate",
                            max_len=ec_kw.get("max_len", 2048), extras=extras)
    emit({"phase": "serve", "model": cfg.name, "check": "tokens vs Server.generate (fp32)",
          "agreed_prefix": agreed, "of": max_new, "excused": excused_counts(excused),
          "excused_divergences": excused})

    sub = [prompts[0], prompts[2], prompts[1]]
    eng = run_engine(cfg, params, sub, [0, 4, 8], 8, backend="reference",
                     extras=extras and [extras[0], extras[2], extras[1]], **ec_kw)
    kernels.reset_launch_counts()
    eng.run()
    torch.cuda.synchronize()
    ref_counts = kernels.launch_counts()
    drained_audit(eng)
    emit({"phase": "serve", "model": cfg.name, "run": "fp32, backend reference",
          "requests": len(sub), "cow_copies": eng.kv.cow_copies, "launches": ref_counts})
    if any(ref_counts.values()) or eng.kv.cow_copies < min_cow:
        raise AssertionError(f"reference backend: launches {ref_counts}, "
                             f"cow {eng.kv.cow_copies} (want >= {min_cow})")
    return counts


def _submit_all(eng, prompts, arrivals, max_new, extras=None, rid0=0):
    """Submit the traffic to an engine, arrivals counted from its current
    step; returns the request ids."""
    rids = []
    for i, (p, t) in enumerate(zip(prompts, arrivals)):
        eng.submit(p, max_new, rid=rid0 + i, arrival_step=eng.step_count + t,
                   extras=extras[i] if extras else None)
        rids.append(rid0 + i)
    return rids


def _captures(eng) -> dict:
    """The chunk graphs an engine captured: shapes, captures and seconds
    (none for a tree without them)."""
    graphs = getattr(eng, "_chunk_graphs", None) or {}
    return {"chunk_shapes": sorted(graphs),
            "chunk_captures": sum(r.captures for r in graphs.values()),
            "chunk_capture_s": sum(r.capture_seconds for r in graphs.values()),
            "chunk_pool_bytes": sum(r.pool_bytes for r in graphs.values())}


def _stepped(torch, eng) -> tuple:
    """Run an engine to the end one step at a time, a sync before and after
    each step; (sorted ms of the steps that only decoded, tokens those
    steps decoded)."""
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
    return sorted(decode_ms), decode_tokens


def timed_serve(torch, cfg16, params, prompts, arrivals, max_new, extras=None,
                **ec_kw) -> dict:
    """The bf16 serving numbers: the run's wall time with the deferred sync
    (as served); on a fresh engine, one sync per step, decode step times
    and TTFT (each chunk shape's first use included: ``ttft_ms``); on that
    engine, its chunk shapes met, the same traffic with other tokens (every
    id plus one: the same lengths and shared prefixes, no hit in the first
    run's prefix cache), TTFT again (``ttft_ms_warm``); one profiled engine
    step of up to four full chunks of one request on that engine, and one
    profiled decode step with 4 slots decoding.  ``extras`` and ``ec_kw``:
    each request's modality inputs and the engine settings, as in
    :func:`gated_serve`."""
    import numpy as np

    eng = run_engine(cfg16, params, prompts, arrivals, max_new, extras=extras,
                     **ec_kw)  # deferred sync, as served
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    useful = sum(len(r.out_tokens) for r in reqs)
    drained_audit(eng)
    shared = {"cached_prompt_tokens": [r.stats.cached_prompt_tokens for r in reqs],
              "cow_copies": eng.kv.cow_copies}
    eng = run_engine(cfg16, params, prompts, arrivals, max_new, extras=extras,
                     **ec_kw)  # one sync per step
    decode_ms, decode_tokens = _stepped(torch, eng)
    reqs = [eng.sched.finished[r] for r in sorted(eng.sched.finished)]
    drained_audit(eng)
    ttft_steps = [r.stats.ttft_steps for r in reqs]
    ttft_ms = [r.stats.ttft_s * 1e3 for r in reqs]
    other = [(p + 1) % cfg16.vocab_size for p in prompts]
    rids = _submit_all(eng, other, arrivals, max_new, extras, rid0=len(prompts))
    _stepped(torch, eng)
    ttft_warm = [eng.sched.finished[r].stats.ttft_s * 1e3 for r in rids]
    drained_audit(eng)
    # one engine step of full chunks only: a fresh request of up to four
    # pages (the admission budget) and one new token, nothing else running
    page = eng.kv.page_size
    n = min(4 * page, (eng.kv.max_len - 1) // page * page)
    rng_tokens = (prompts[0][:1].repeat(n) + np.arange(n) + 2) % cfg16.vocab_size
    _submit_all(eng, [rng_tokens.astype(np.int32)], [0], 1, extras and extras[:1],
                rid0=2 * len(prompts))
    chunks = eng.prefill_chunks
    chunk_prof = profile_forward(torch, eng.step, warm=False)
    chunk_prof["chunks"] = eng.prefill_chunks - chunks
    eng.run()
    captured = _captures(eng)
    # one profiled decode step: 4 slots decoding, no admission pending
    eng = run_engine(cfg16, params, prompts[3:7], [0, 0, 0, 0], max_new,
                     extras=extras and extras[3:7], **ec_kw)
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
            "ttft_ms_median": statistics.median(ttft_ms), "ttft_ms_warm": ttft_warm,
            "ttft_ms_median_warm": statistics.median(ttft_warm), **shared, **captured,
            "profiled_chunk_step": chunk_prof, "profiled_decode_step": prof}


def serve_timing(torch, names=None) -> dict:
    """``timed_serve`` alone for the served models of phases 6 and 8-12, in
    bf16 at their cuts, on their traffic (weights from seed 0): for a paired
    call of two trees, run it once with each tree's ``src`` first on
    ``sys.path``.  ``names``: a subset of the rows.  Returns {name: line}."""
    import dataclasses

    import repro_torch.configs as C
    from repro_torch.launch.serve import audio_extras
    from repro_torch.models import model as M

    dense = dict(n_layers=3, family="dense", n_experts=0, n_shared_experts=0, top_k=0,
                 moe_d_ff=0, first_k_dense=0, mtp_depth=0)
    deepseek = C.get_config("deepseek-v3-671b")
    rows = {
        "starcoder2-7b": lambda: C.get_config("starcoder2-7b"),
        "deepseek-v3 dense prefix": lambda: dataclasses.replace(deepseek, **dense),
        "granite-moe-3b-a800m": lambda: C.get_config(
            "granite-moe-3b-a800m", n_layers=CUT_DEPTH["granite-moe-3b-a800m"]),
        "deepseek-v3 4 layers": lambda: dataclasses.replace(deepseek, n_layers=4),
        "h2o-danube-3-4b": lambda: C.get_config(
            "h2o-danube-3-4b", n_layers=CUT_DEPTH["h2o-danube-3-4b"]),
        "mamba2-130m": lambda: C.get_config("mamba2-130m"),
        "hymba-1.5b": lambda: C.get_config("hymba-1.5b", n_layers=CUT_DEPTH["hymba-1.5b"]),
        "whisper-tiny": lambda: C.get_config("whisper-tiny"),
    }
    out = {}
    for name in names or rows:
        cfg16 = rows[name]()
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = M.init_params(cfg16, gen, device="cuda")
        if cfg16.n_encoder_layers:
            prompts, arrivals = whisper_traffic(cfg16.vocab_size)
            line = timed_serve(torch, cfg16, params, prompts, arrivals, 64,
                               extras=audio_extras(cfg16, len(prompts), seed=0),
                               max_len=WHISPER_CONTEXT)
        else:
            prompts, arrivals = serve_traffic(cfg16.vocab_size)
            line = timed_serve(torch, cfg16, params, prompts, arrivals, 64)
        out[name] = line
        emit({**line, "timing": name})
        del params
        torch.cuda.empty_cache()
    return out


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
    agreed, _ = agree(cfg4, params4, short, [r.out_tokens for r in reqs], 16,
                      "rwma engine vs the xla route")
    emit({"phase": "serve", "run": "fp32, 4 layers, gemm_backend rwma",
          "launches": rwma_counts, "agreed_prefix": agreed, "of": 16})
    if not rwma_counts["rwma_gemm"]:
        raise AssertionError("the rwma route launched no rwma_gemm")
    result["rwma_launches"] = rwma_counts["rwma_gemm"]
    del params, params4, eng
    torch.cuda.empty_cache()
    serve_timing(torch, ["starcoder2-7b"])  # timed, bf16 (the config's type)
    return result


# phase 7's MLA decode: one DeepSeek-V3 layer's decode (B, H, r, dr, page,
# maxp) at these positions
MLA_SHAPE = (4, 128, 512, 64, 128, 16)
MLA_SEQ = [0, 127, 1000, 1900]


def mla_table(torch):
    """Phase 7's scattered page table (unmapped entries on the null page),
    its positions and the model's scale, (qk_nope + qk_rope) ** -0.5."""
    import numpy as np

    B, H, r, dr, page, maxp = MLA_SHAPE
    rng = np.random.default_rng(1)
    table = np.zeros((B, maxp), np.int32)
    phys = rng.permutation(np.arange(1, B * maxp + 1))
    for b, pos in enumerate(MLA_SEQ):
        used = pos // page + 1
        table[b, :used] = phys[b * maxp:b * maxp + used]
    return (torch.from_numpy(table).to("cuda"),
            torch.tensor(MLA_SEQ, dtype=torch.int32, device="cuda"), (128 + dr) ** -0.5)


def mla_operands(torch, gen, dtype):
    """Phase 7's MLA decode operands in ``dtype``, drawn from ``gen``."""
    B, H, r, dr, page, maxp = MLA_SHAPE
    q_lat, q_rope = (torch.randn(B, 1, H, n, generator=gen, device=gen.device).to(
        "cuda", dtype) for n in (r, dr))
    ckv, krope = (torch.randn(B * maxp + 1, page, n, generator=gen, device=gen.device).to(
        "cuda", dtype) for n in (r, dr))
    return (q_lat, q_rope, ckv, krope) + mla_table(torch)[:2]


def mla_decode_device_ms(repeats: int = 3) -> dict:
    """The MLA decode's device ms per launch at phase 7's shape, in fp32 and
    bf16, with its largest error against the plain version but no gate: for
    a variant of the kernel that need not pass one (another accumulation
    type, split or tile), run with that tree's ``src`` first on
    ``sys.path``.  Prints and returns one JSON line."""
    import torch

    from repro_torch.kernels.paged_attention import mla_decode_plain, mla_paged_attention_decode

    gen = torch.Generator(device="cpu").manual_seed(0)
    scale = mla_table(torch)[2]
    row = {"phase": "mla_decode_device_ms", "module": mla_paged_attention_decode.__module__,
           "file": sys.modules[mla_paged_attention_decode.__module__].__file__}
    for dtype in (torch.float32, torch.bfloat16):
        args = mla_operands(torch, gen, dtype)
        got = mla_paged_attention_decode(*args, scale=scale).float()
        want = mla_decode_plain(*args, scale=scale).float()
        name = str(dtype).split(".")[-1]
        row[f"{name}_max_abs_err"] = (got - want).abs().max().item()
        runs = [device_and_host("mla_paged_attention_decode",
                                lambda: mla_paged_attention_decode(*args, scale=scale))
                for _ in range(repeats)]
        row[f"{name}_device_ms"] = [run["device_ms"] for run in runs]
        row[f"{name}_combine_device_ms"] = [run.get("follow_up_device_ms") for run in runs]
    emit(row)
    return row


def mla_kernel_phase(torch, gen):
    """mla_paged_attention_decode, bwma_softmax and bwma_transpose against
    their plain versions at this slice's shapes, timed.  Returns {kernel:
    summary row}, each row's times for the configuration in its ``work``."""
    import torch.nn.functional as F

    from repro_torch.core.layout import BlockLayout, to_blockwise
    from repro_torch.kernels.bwma_softmax import bwma_softmax, softmax_plain, softmax_plan
    from repro_torch.kernels.bwma_transpose import (bwma_transpose, transpose_plain,
                                                    transpose_plan)
    from repro_torch.kernels.paged_attention import (mla_decode_plain, mla_decode_plan,
                                                     mla_paged_attention_decode)

    out = {}
    # registers and spills of the MLA kernels, compiled beside the timing
    ptxas = ptxas_usage("paged_attention.cu", "mla_decode")
    # -- mla_paged_attention_decode at DeepSeek-V3 decode shapes
    B, H, r, dr, page, maxp = MLA_SHAPE
    seq = MLA_SEQ
    table_t, seq_t, scale = mla_table(torch)
    n_keys = sum(p + 1 for p in seq)
    for dtype in (torch.float32, torch.bfloat16):
        args = mla_operands(torch, gen, dtype)
        q_lat, q_rope, ckv, krope = args[:4]
        got = mla_paged_attention_decode(*args, scale=scale).float()
        want = mla_decode_plain(*args, scale=scale).float()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ok = err <= PAGED_TOL if dtype == torch.float32 else bool(
            torch.all((got - want).abs() <= BF16_ROUNDING * want.abs() + PAGED_TOL))
        name = str(dtype).split(".")[-1]
        if not ok:
            raise AssertionError(f"mla_paged_attention_decode {name}: max err {err}")
        # batch invariance (each slot alone, and behind maxp doubled by
        # null-page columns) and run-to-run bit identity
        full = mla_paged_attention_decode(*args, scale=scale)
        wide = mla_paged_attention_decode(*args[:4], torch.cat([table_t,
                                                                torch.zeros_like(table_t)], 1),
                                          seq_t, scale=scale)
        for b in range(B):
            alone = mla_paged_attention_decode(q_lat[b:b + 1], q_rope[b:b + 1], ckv, krope,
                                               table_t[b:b + 1], seq_t[b:b + 1], scale=scale)
            if not (torch.equal(alone[0], full[b]) and torch.equal(wide[b], full[b])):
                raise AssertionError(f"mla_paged_attention_decode {name}: slot {b} is not "
                                     "batch invariant")
        if not torch.equal(mla_paged_attention_decode(*args, scale=scale), full):
            raise AssertionError(f"mla_paged_attention_decode {name}: not bit-identical run "
                                 "to run")
        split_keys, splits = mla_decode_plan(page, maxp, dtype)
        heads = csrc_constant("paged_attention.cu", "kMlaHeads")
        live = sum(-(-(p + 1) // split_keys) for p in seq)
        emit({"phase": "mla_kernels", "kernel": "mla_paged_attention_decode", "dtype": name,
              "plan": {"split_keys": split_keys, "splits": splits, "heads_per_cta": heads,
                       "grid": [-(-H // heads), B, splits], "live_splits": live,
                       "live_ctas": live * -(-H // heads)}})
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
               "batch_invariant": True, "bit_identical_run_to_run": True,
               "work": f"one layer's decode, B={B} H={H} r={r} dr={dr} page={page} "
                       f"seq_pos={seq} ({name} pools)",
               **device_and_host("mla_paged_attention_decode",
                                 lambda: mla_paged_attention_decode(*args, scale=scale),
                                 library)}
        emit(row)
        out.setdefault("mla_paged_attention_decode", row)
        del q_lat, q_rope, ckv, krope, cg, kg, qs, full, wide
    emit({"phase": "mla_kernels", "kernel": "mla_paged_attention_decode",
          "ptxas": read_ptxas(ptxas)})
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
    serve_timing(torch, ["deepseek-v3 dense prefix"])
    return counts


def moe_first_token_gates(torch, kernels, cfg, params, prompts, arrivals, max_new,
                          decode_kernel):
    """The gates of a MoE model served in bf16 only (too large for fp32 on
    one card): one run with one-shot prefill, counts set to 0 just before
    it, every logit finite, a clean audit, ``decode_kernel`` once per layer
    and decode step and no other kernel, and each
    request's first token equal to ``Server.generate``'s (both prefill the
    same one-shot (1, S) group).  Returns the launch counts."""
    import dataclasses

    from repro_torch.serve import ServeConfig, Server

    eng = run_engine(cfg, params, prompts, arrivals, max_new, chunked_prefill=False)
    finite = []
    real_decode, real_prefill = eng._decode, eng._prefill

    def decode(*args):
        greedy, logits, caches = real_decode(*args)
        finite.append(torch.isfinite(logits).all())
        return greedy, logits, caches

    def prefill(*args):
        logits, caches = real_prefill(*args)
        finite.append(torch.isfinite(logits).all())
        return logits, caches

    eng._decode, eng._prefill = decode, prefill
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    audit = drained_audit(eng)
    all_finite = bool(torch.stack(finite).all())
    server = Server(cfg, params, ServeConfig(max_len=2048), device="cuda")
    want = [int(server.generate({"tokens": p[None]}, 1)[0][0]) for p in prompts]
    got = [r.out_tokens[0] for r in reqs]
    emit({"phase": "moe_serve", "model": cfg.name, "run": "bf16 gates, one-shot prefill",
          "layers": cfg.n_layers, "requests": len(reqs), "decode_steps": eng.decode_steps,
          "launches": counts, "audit": dataclasses.asdict(audit), "logits_finite": all_finite,
          "first_tokens": got, "first_tokens_generate": want, "wall_s": wall})
    if counts[decode_kernel] != cfg.n_layers * eng.decode_steps:
        raise AssertionError(f"{decode_kernel} launched {counts[decode_kernel]} times, not "
                             f"{cfg.n_layers} x {eng.decode_steps} decode steps")
    others = {k: n for k, n in counts.items() if n and k != decode_kernel}
    if others or not all_finite or got != want:
        raise AssertionError(f"{cfg.name}: other launches {others}, finite {all_finite}, "
                             f"first tokens {got} vs generate {want}")
    return counts


def moe_serve_phase(torch, kernels):
    """granite-moe-3b-a800m at full width, then DeepSeek-V3 cut to its three
    dense layers and one MoE layer at full width, through the continuous
    engine."""
    import dataclasses

    import repro_torch.configs as C
    from repro_torch.models import model as M

    max_new = 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    # -- granite, fp32 gates: one-shot prefill dispatches each prompt as the
    # group Server.generate uses (sharing switches itself off there, so no
    # copy-on-write is required)
    layers = CUT_DEPTH["granite-moe-3b-a800m"]
    cfg = C.get_config("granite-moe-3b-a800m", dtype=torch.float32, n_layers=layers)
    prompts, arrivals = serve_traffic(cfg.vocab_size)
    decode_errs = paged_decode_checks(torch, GRANITE_DECODE, DECODE_SEQ, cfg.name)
    params = M.init_params(cfg, gen, device="cuda")
    granite = gated_serve(torch, kernels, cfg, params, prompts, arrivals, max_new,
                          "paged_attention_decode", min_cow=0, chunked_prefill=False)
    del params
    torch.cuda.empty_cache()
    serve_timing(torch, ["granite-moe-3b-a800m"])

    # -- DeepSeek-V3, 4 layers (3 dense + 1 MoE of 256 routed experts and a
    # shared one), bf16 only: about 30 GB of weights, 60 GB in fp32
    cfg16 = dataclasses.replace(C.get_config("deepseek-v3-671b"), n_layers=4)
    prompts, arrivals = serve_traffic(cfg16.vocab_size)
    params = M.init_params(cfg16, gen, device="cuda")
    deepseek = moe_first_token_gates(torch, kernels, cfg16, params, prompts, arrivals,
                                     max_new, "mla_paged_attention_decode")
    del params
    torch.cuda.empty_cache()
    serve_timing(torch, ["deepseek-v3 4 layers"])
    return {"granite": granite, "granite_decode_errs": decode_errs, "deepseek": deepseek}


def whisper_traffic(vocab: int):
    """8 decoder prompts of 100-384 tokens from a numpy seed, each with room
    for 64 new tokens inside whisper's 448-token context; prompt 2 repeats
    prompt 0's tokens (under other audio: nothing may be shared).  Arrivals
    every 4 engine steps."""
    import numpy as np

    longest = WHISPER_CONTEXT - 64
    rng = np.random.default_rng(0)
    lens = rng.integers(100, longest + 1, size=8)
    lens[0] = longest  # its slot fills the context
    prompts = [rng.integers(0, vocab, size=(int(n),)).astype(np.int32) for n in lens]
    prompts[2] = prompts[0].copy()
    return prompts, [4 * i for i in range(len(prompts))]


def long_traffic(vocab: int):
    """3 prompts of 4200-4600 tokens from a numpy seed, past a 4096-token
    window: the ring wraps in prefill.  Arrivals every 4 engine steps."""
    import numpy as np

    rng = np.random.default_rng(1)
    lens = rng.integers(4200, 4601, size=3)
    return ([rng.integers(0, vocab, size=(int(n),)).astype(np.int32) for n in lens],
            [0, 4, 8])


def swa_serve_phase(torch, kernels):
    """h2o-danube-3-4b at full width through the continuous engine: its
    sliding-window ring rows, which run no kernel."""
    import repro_torch.configs as C
    from repro_torch.models import model as M

    gen = torch.Generator(device="cuda").manual_seed(0)
    layers = CUT_DEPTH["h2o-danube-3-4b"]
    cfg = C.get_config("h2o-danube-3-4b", dtype=torch.float32, n_layers=layers)
    prompts, arrivals = long_traffic(cfg.vocab_size)
    if min(len(p) for p in prompts) <= cfg.window:
        raise AssertionError("the prompts must pass the window for the ring to wrap")
    params = M.init_params(cfg, gen, device="cuda")
    counts = gated_serve(torch, kernels, cfg, params, prompts, arrivals, 16, None,
                         min_cow=0, max_len=8192)
    del params
    torch.cuda.empty_cache()
    serve_timing(torch, ["h2o-danube-3-4b"])  # bf16, on the 8 shorter requests
    return counts


def ssm_serve_phase(torch, kernels):
    """mamba2-130m, then hymba-1.5b, at full width through the continuous
    engine: SSM state rows (and, in Hymba, the sliding-window ring beside
    them), which run no kernel."""
    import repro_torch.configs as C
    from repro_torch.models import model as M

    gen = torch.Generator(device="cuda").manual_seed(0)
    counts = {}
    for arch in ("mamba2-130m", "hymba-1.5b"):
        depth = {"n_layers": CUT_DEPTH[arch]} if arch in CUT_DEPTH else {}
        cfg = C.get_config(arch, dtype=torch.float32, **depth)
        prompts, arrivals = serve_traffic(cfg.vocab_size)
        if cfg.attn_type == "swa" and max(len(p) for p in prompts) <= cfg.window:
            raise AssertionError("a prompt must pass the window for the ring to wrap")
        params = M.init_params(cfg, gen, device="cuda")
        # chunks of 128 sit on the SSD chunk grid (lcm of the adapters' grids)
        counts[arch] = gated_serve(torch, kernels, cfg, params, prompts, arrivals, 64, None,
                                   min_cow=0)
        del params
        torch.cuda.empty_cache()
        serve_timing(torch, [arch])
    return counts


def encdec_serve_phase(torch, kernels):
    """whisper-tiny at full width through the continuous engine, each
    request with its own audio and within whisper's decoder context:
    immutable cross rows installed at admission and the decoder's paged
    self-attention through paged_attention_decode, first checked against
    its plain version at the run's decode shape.  Returns the gated run's
    launch counts and the kernel check's errors."""
    import repro_torch.configs as C
    from repro_torch.launch.serve import audio_extras
    from repro_torch.models import model as M

    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg = C.get_config("whisper-tiny", dtype=torch.float32)
    prompts, arrivals = whisper_traffic(cfg.vocab_size)
    extras = audio_extras(cfg, len(prompts), seed=0)  # (1, 1500, 384) each
    decode_errs = paged_decode_checks(torch, WHISPER_DECODE, WHISPER_SEQ, cfg.name)
    params = M.init_params(cfg, gen, device="cuda")
    counts = gated_serve(torch, kernels, cfg, params, prompts, arrivals, 64,
                         "paged_attention_decode", min_cow=0, extras=extras,
                         max_len=WHISPER_CONTEXT)
    del params
    torch.cuda.empty_cache()
    serve_timing(torch, ["whisper-tiny"])
    return counts, decode_errs


# the vision frontend (phase 13): Qwen2-VL's image grid, 32 x 32 patches
VISION_TEXT = 256
VISION_GRID = 32
VISION_VARIED_TEXT = (224, 192, 160, 128, 96, 64)  # vision_timing's varied waves
# a logit difference that an image or a position stream must exceed
CHANGED = 1e-3
# phase 14: the 2-layer fp32 gate's tolerances (loss relative; each gradient
# leaf against its own max |g|; parameters after 3 AdamW steps absolute)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-4
TRAIN_PARAM_TOL = 1e-5
# the full-depth bf16 run: the resumed run's losses against the uninterrupted
# run's, relative (bf16, the card's reductions may run in another order)
RESUME_RTOL = 1e-2
# the mean of the last 5 losses must lie this far below step 0 (nats): half
# the fall of a cut run (2 layers at full width, the same batches: 11.92 ->
# 5.20 on an H100, PERF.md), rounded down
LOSS_DROP = 3.0


def vision_traffic(cfg):
    """4 requests of a (1, 1024, d_model) standard-normal image from a numpy
    seed over the first 1024 tokens and 256 text tokens after it, all on
    Qwen2-VL's grid positions: the image at t = 0, h = i // 32, w = i % 32,
    the text from 32 on all three streams.  Request 1 has request 0's tokens
    (another image)."""
    import numpy as np

    n = cfg.n_frontend_tokens
    S = n + VISION_TEXT
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=(S,)).astype(np.int32) for _ in range(4)]
    prompts[1] = prompts[0].copy()
    i = np.arange(n)
    img = np.stack([np.zeros(n), i // VISION_GRID, i % VISION_GRID])
    text = np.broadcast_to(img.max() + 1 + np.arange(VISION_TEXT), (3, VISION_TEXT))
    p3 = np.concatenate([img, text], 1).astype(np.int32)[:, None]  # (3, 1, S)
    extras = [{"vis_embeds": rng.standard_normal((1, n, cfg.d_model), dtype=np.float32),
               "positions3": p3} for _ in prompts]
    return prompts, extras


def _wave(torch, prompts, extras, device="cuda"):
    import numpy as np

    return {"tokens": torch.from_numpy(np.stack(prompts)).to(device),
            "vis_embeds": torch.from_numpy(np.concatenate(
                [e["vis_embeds"] for e in extras])).to(device),
            "positions3": torch.from_numpy(np.concatenate(
                [e["positions3"] for e in extras], axis=1)).to(device)}


def vision_serve_phase(torch, kernels):
    """qwen2-vl-72b at full width, cut to 4 of its 80 layers, through the
    static ``Server``: an image prefix per request and M-RoPE over three
    different position streams.  No kernel runs on this path (the JAX
    package serves it with plain XLA, no Pallas call)."""
    import repro_torch.configs as C
    from repro_torch.models import model as M
    from repro_torch.serve import ServeConfig, Server

    max_new, layers = 64, 4
    cfg = C.get_config("qwen2-vl-72b", dtype=torch.float32, n_layers=layers)
    prompts, extras = vision_traffic(cfg)
    S = len(prompts[0])
    max_len = S + max_new
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = M.init_params(cfg, gen, device="cuda")
    srv = Server(cfg, params, ServeConfig(max_len=max_len), device="cuda")
    wave = _wave(torch, prompts, extras)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    got = srv.generate(wave, max_new)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"the vision path launched kernels: {counts}")
    agreed, excused = agree(cfg, params, prompts, got, max_new,
                            "qwen2-vl-72b fp32 wave vs Server.generate", max_len=max_len,
                            extras=extras)
    # the image and the streams reach the logits
    with torch.no_grad():
        first = M.prefill(cfg, params, {k: v[:2] for k, v in wave.items()
                                        if k != "positions3"}
                          | {"positions3": wave["positions3"][:, :2]})[0]
        image_diff = (first[0] - first[1]).abs().max().item()  # same tokens, two images
        flat = torch.arange(S, device="cuda", dtype=torch.int32)[None, None].expand(3, 1, S)
        equal_streams = M.prefill(cfg, params, {"tokens": wave["tokens"][:1],
                                                "vis_embeds": wave["vis_embeds"][:1],
                                                "positions3": flat})[0]
        stream_diff = (equal_streams[0] - first[0]).abs().max().item()
    emit({"phase": "vision", "model": cfg.name, "run": "fp32 gates, static Server",
          "layers": layers, "requests": len(prompts), "prompt_len": S,
          "image_tokens": cfg.n_frontend_tokens, "max_new": max_new, "launches": counts,
          "agreed_prefix": agreed, "of": max_new, "excused": excused_counts(excused),
          "excused_divergences": excused,
          "first_logits_two_images_max_abs_diff": image_diff,
          "first_logits_grid_vs_equal_streams_max_abs_diff": stream_diff})
    if image_diff < CHANGED or stream_diff < CHANGED:
        raise AssertionError(f"the image ({image_diff}) or the streams ({stream_diff}) do "
                             f"not move the logits by {CHANGED}")
    del params, srv, first, equal_streams
    torch.cuda.empty_cache()

    vision_timing(torch)  # timed, bf16 (the config's type)
    return counts


def vision_timing(torch, layers: int = 4, max_new: int = 64, waves: int = 3) -> dict:
    """The bf16 vision numbers through the static ``Server``: qwen2-vl-72b
    at full width, ``layers`` deep, weights from seed 0, the wave of
    :func:`vision_traffic` generated ``waves`` times; each prefill and
    decode step timed with a sync before and after (the Server's ``_prefill``
    and ``_decode``, which both trees have: a paired call runs it with each
    tree's ``src`` first on ``sys.path``), then one decode step profiled;
    then one wave at each of the prompt lengths ``VISION_VARIED_TEXT``
    text tokens after the image, 8 new tokens, each prefill timed.  A
    prompt shape's first prefill holds its capture on a tree that captures
    one."""
    import dataclasses

    import repro_torch.configs as C
    from repro_torch.models import model as M
    from repro_torch.serve import ServeConfig, Server

    cfg16 = dataclasses.replace(C.get_config("qwen2-vl-72b"), n_layers=layers)
    prompts, extras = vision_traffic(cfg16)
    S = len(prompts[0])
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = M.init_params(cfg16, gen, device="cuda")
    srv = Server(cfg16, params, ServeConfig(max_len=S + max_new), device="cuda")
    wave = _wave(torch, prompts, extras)
    times = {"_prefill": [], "_decode": []}
    last = {}

    def timed(name):
        real = getattr(srv, name)

        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = real(*args)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t) * 1e3)
            last[name] = (real, args)
            return out

        setattr(srv, name, run)

    timed("_prefill")
    timed("_decode")
    for _ in range(waves):
        srv.generate(wave, max_new)
    real, args = last["_decode"]
    prof = profile_forward(torch, lambda: real(*args))
    decode_ms = sorted(times["_decode"])
    mem = {"allocated_bytes_fixed": torch.cuda.memory_allocated(),
           "reserved_bytes_fixed": torch.cuda.memory_reserved()}
    # varied traffic: one wave at each of six shorter prompts, every shape new
    n_img = S - VISION_TEXT
    for t in VISION_VARIED_TEXT:
        n = n_img + t
        srv.generate({"tokens": wave["tokens"][:, :n], "vis_embeds": wave["vis_embeds"],
                      "positions3": wave["positions3"][:, :, :n]}, 8)
    varied_ms = times["_prefill"][waves:]
    mem.update(allocated_bytes_varied=torch.cuda.memory_allocated(),
               reserved_bytes_varied=torch.cuda.memory_reserved())
    graphs = [*getattr(srv, "_prefill_graphs", {}).values(),
              *getattr(srv, "_decode_graphs", {}).values()]
    line = {"phase": "vision", "model": cfg16.name, "run": "bf16 timed, static Server",
            "layers": layers, "batch": len(prompts), "prompt_len": S, "waves": waves,
            "prefill_ms": times["_prefill"][:waves],
            "prefill_ms_median": statistics.median(times["_prefill"][:waves]),
            "varied_prompt_lens": [n_img + t for t in VISION_VARIED_TEXT],
            "varied_prefill_ms": varied_ms, "varied_prefill_ms_sum": sum(varied_ms),
            "decode_step_ms_median": statistics.median(decode_ms),
            "decode_step_ms_p90": decode_ms[int(0.9 * (len(decode_ms) - 1))],
            "decode_steps_timed": len(decode_ms),
            "decode_tok_s": len(prompts) * len(decode_ms) / (sum(decode_ms) / 1e3),
            "captures": sum(g.captures for g in graphs),
            "capture_s": [g.capture_seconds for g in graphs],
            "pool_bytes": [g.pool_bytes for g in graphs], **mem,
            "profiled_decode_step": prof}
    emit(line)
    del params, srv, wave, last, real, args
    torch.cuda.empty_cache()
    return line


def paired_timing(src: str, names=None) -> None:
    """One side of a paired timing call: :func:`serve_timing` (``names``,
    default every row) and :func:`vision_timing` with the tree ``src``
    (a directory holding ``repro_torch``) first on ``sys.path``, in a
    process of its own; prints the card's line first.  Run it as
    ``python3 -c "import chip_smoke; chip_smoke.paired_timing('SRC')"`` once
    per tree, alternating."""
    sys.path.insert(0, str(Path(src).resolve()))
    import torch

    import repro_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "paired_timing", "src": src, "repro_torch": repro_torch.__file__,
          "nvidia_smi": smi})
    serve_timing(torch, names)
    vision_timing(torch)


def _leaf_rel_errors(torch, got, want):
    """Each leaf's max |got - want| over that leaf's max |want| (CPU side)."""
    out = []
    for g, w in zip(got, want):
        scale = w.abs().max().item()
        out.append((g.cpu() - w).abs().max().item() / max(scale, 1e-30))
    return out


def train_gate(torch, kernels):
    """minicpm-2b at full width cut to 2 layers, fp32, batch 2 x 128: one
    ``loss_fn`` and its gradients on the card against the same call on the
    CPU (the port's own code, same weights and batch), then 3 AdamW steps
    on each; no kernel launch; the bwma route refuses autograd."""
    import dataclasses

    import repro_torch.configs as C
    from repro_torch import tree as T
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import model as M
    from repro_torch.optim import OptConfig, adamw_init, adamw_update, wsd_schedule

    cfg = C.get_config("minicpm-2b", dtype=torch.float32, n_layers=2)
    cpu = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = T.tree_map(lambda x: x.to("cuda"), cpu)
    data = SyntheticLMData(cfg, global_batch=2, seq_len=128)
    oc = OptConfig(lr=1e-3)
    lr_fn = wsd_schedule(oc.lr, 3, 21, 6)  # the full run's schedule
    opt_cpu, opt_card = adamw_init(cpu, oc), adamw_init(card, oc)
    kernels.reset_launch_counts()
    losses, worst, near_zero, lr_sum = [], [], [], 0.0
    for step in range(3):
        batch = data.batch(step)
        t = time.perf_counter()
        l_card, _, g_card = loss_and_grads(cfg, card, {k: v.cuda() for k, v in batch.items()})
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t
        l_cpu, _, g_cpu = loss_and_grads(cfg, cpu, batch)
        losses.append({"step": step, "card": l_card.item(), "cpu": l_cpu.item(),
                       "card_s": card_s})
        errs = _leaf_rel_errors(torch, g_card, g_cpu)
        worst.append(max(errs))
        if step == 0:
            i = max(range(len(errs)), key=errs.__getitem__)
            worst_leaf = T.paths(cpu)[i]
        # elements whose gradient lies inside the gate's tolerance of zero:
        # there the sign of AdamW's first moves is not fixed by the gradient
        near = [(g.abs() <= TRAIN_GRAD_TOL * g.abs().max()) for g in g_cpu]
        near_zero = near if not near_zero else [a | b for a, b in zip(near_zero, near)]
        lr_now = lr_fn(step)
        lr_sum += float(lr_now)
        cpu, opt_cpu = adamw_update(T.unflatten(cpu, g_cpu), opt_cpu, cpu, oc, lr_now)
        card, opt_card = adamw_update(T.unflatten(card, g_card), opt_card, card, oc,
                                      lr_fn(torch.tensor(step, device="cuda")))
        del g_card, g_cpu
    counts = kernels.launch_counts()
    excused, beyond, param_err = 0, 0.0, 0.0
    for p_card, p_cpu, near in zip(T.leaves(card), T.leaves(cpu), near_zero):
        diff = (p_card.cpu() - p_cpu).abs()
        over = diff > TRAIN_PARAM_TOL
        param_err = max(param_err, diff[~near].max().item() if (~near).any() else 0.0)
        excused += int((over & near).sum())
        if (over & near).any():
            beyond = max(beyond, diff[over & near].max().item())
    bwma = dataclasses.replace(cfg, gemm_backend="bwma")
    try:
        loss_and_grads(bwma, card, {k: v.cuda() for k, v in data.batch(0).items()})
        refused = None
    except RuntimeError as e:
        refused = str(e)
    row = {"phase": "train", "model": cfg.name, "run": "fp32 gate, card vs CPU",
           "layers": cfg.n_layers, "batch": [2, 128], "losses": losses,
           "grad_max_rel_err_by_step": worst, "worst_leaf_step0": worst_leaf,
           "param_max_abs_err_after_3_steps": param_err,
           "params_past_tol_with_near_zero_grad": excused,
           "their_max_abs_err": beyond, "their_bound": 2.5 * lr_sum,
           "launches": counts, "bwma_under_autograd": refused}
    emit(row)
    if any(abs(r["card"] - r["cpu"]) > TRAIN_LOSS_RTOL * abs(r["cpu"]) for r in losses):
        raise AssertionError(f"card loss vs CPU loss beyond {TRAIN_LOSS_RTOL}: {losses}")
    if max(worst) > TRAIN_GRAD_TOL:
        raise AssertionError(f"a gradient leaf is {max(worst)} of its max |g| off")
    if param_err > TRAIN_PARAM_TOL or beyond > 2.5 * lr_sum:
        raise AssertionError(f"parameters after 3 steps: {param_err} (tol {TRAIN_PARAM_TOL}); "
                             f"near-zero-gradient elements {beyond} (bound {2.5 * lr_sum})")
    if any(counts.values()):
        raise AssertionError(f"the training step launched kernels: {counts}")
    if refused is None or "no backward" not in refused:
        raise AssertionError("gemm_backend='bwma' did not refuse autograd")
    return row


def _trees_equal(torch, a, b) -> bool:
    from repro_torch import tree as T

    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(T.leaves(a), T.leaves(b)))


def train_phase(torch, kernels):
    """The fp32 gate (:func:`train_gate`), then minicpm-2b at full width and
    depth in bf16 with fp32 moments, batch 4 x 512, WSD, through
    ``Trainer.fit``: 30 uninterrupted steps (timed; one step profiled), then
    20 steps that end in a checkpoint, which must restore bit for bit, and
    the 10 steps resumed from it (``restore_or_init`` and ``step_fn``: fit's
    loop without its closing save), whose losses must lie within
    ``RESUME_RTOL`` of the uninterrupted run's."""
    import shutil
    import tempfile

    import repro_torch.configs as C
    from repro_torch import tree as T
    from repro_torch.data import SyntheticLMData
    from repro_torch.optim import OptConfig, wsd_schedule
    from repro_torch.train import Trainer, TrainerConfig

    gate = train_gate(torch, kernels)
    torch.cuda.empty_cache()
    steps, batch, seq = 30, 4, 512
    cfg = C.get_config("minicpm-2b")
    data = SyntheticLMData(cfg, global_batch=batch, seq_len=seq)
    oc = OptConfig(lr=1e-3)

    def trainer(n, **tc_kw):  # the CLI's WSD split of the 30 steps
        return Trainer(cfg, None, TrainerConfig(steps=n, checkpoint_every=0, log_every=1,
                                                **tc_kw),
                       oc, wsd_schedule(oc.lr, steps // 10, steps * 7 // 10, steps // 5),
                       device="cuda")

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    tr = trainer(steps)
    params, opt, hist = tr.fit(data)
    counts = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(p.numel() for p in T.leaves(params))
    on_card = {k: v.cuda() for k, v in data.batch(steps).items()}
    prof = profile_forward(torch, lambda: tr.step_fn(params, opt, on_card))
    del params, opt, tr
    torch.cuda.empty_cache()
    losses = [h["loss"] for h in hist]
    step_ms = sorted(h["s"] * 1e3 for h in hist[1:])  # step 0 warms up
    median = statistics.median(step_ms)
    tokens = batch * seq

    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        tr = trainer(20, checkpoint_dir=d)
        t = time.perf_counter()
        params, opt, hist_a = tr.fit(data)  # its last act: the step-20 checkpoint
        first_s = time.perf_counter() - t
        t = time.perf_counter()
        _, restored = tr.ckpt.restore((params, opt), step=20, device="cuda")
        restore_s = time.perf_counter() - t
        bit_exact = _trees_equal(torch, restored, (params, opt))
        ckpt_gb = sum(os.path.getsize(os.path.join(d, "step_00000020", f))
                      for f in os.listdir(os.path.join(d, "step_00000020"))) / 1e9
        del params, opt, restored, tr
        torch.cuda.empty_cache()
        # the resume: the trainer's own restore and step, fit's loop without
        # its closing save (a call may write 45 GiB to the machine's disk;
        # a second 27 GB checkpoint would pass that)
        t = time.perf_counter()
        tr = trainer(steps, checkpoint_dir=d)
        step0, params, opt = tr.restore_or_init()
        hist_b = []
        for step in range(step0, steps):
            on_card = {k: v.cuda() for k, v in data.batch(step).items()}
            params, opt, metrics = tr.step_fn(params, opt, on_card)
            hist_b.append({"step": step, "loss": float(metrics["loss"])})
        resume_s = time.perf_counter() - t
        del params, opt, tr
    finally:
        shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    resumed = [h["loss"] for h in hist_b]
    first = [h["loss"] for h in hist_a]
    resume_err = max(abs(a - b) / abs(b) for a, b in zip(resumed, losses[20:]))
    first_err = max(abs(a - b) / abs(b) for a, b in zip(first, losses[:20]))
    row = {"phase": "train", "model": cfg.name, "run": "bf16, fp32 moments, Trainer.fit",
           "layers": cfg.n_layers, "batch": [batch, seq], "steps": steps,
           "parameters": n_params, "losses": losses,
           "loss_step0": losses[0], "loss_last5_mean": statistics.mean(losses[-5:]),
           "step_ms_median": median, "step_ms_p90": step_ms[int(0.9 * (len(step_ms) - 1))],
           "step0_ms": hist[0]["s"] * 1e3, "tokens_per_s": tokens / (median / 1e3),
           "max_memory_allocated_gb": peak_gb,
           "bf16_peak_share_spec": 6 * n_params * tokens / (median / 1e3) / PEAK_BF16_FLOPS,
           "profiled_step": prof, "launches": counts,
           "checkpoint_gb": ckpt_gb, "first_20_steps_and_save_s": first_s,
           "restore_s": restore_s, "restore_bit_exact": bit_exact,
           "resume_10_steps_s": resume_s, "resumed_from": step0, "resumed_losses": resumed,
           "resumed_max_rel_err": resume_err, "first_20_max_rel_err": first_err}
    emit(row)
    if not all(math.isfinite(x) for x in losses + resumed + first):
        raise AssertionError("a loss is not finite")
    if row["loss_last5_mean"] > losses[0] - LOSS_DROP:
        raise AssertionError(f"the loss fell from {losses[0]} to {row['loss_last5_mean']}, "
                             f"not by {LOSS_DROP}")
    if not bit_exact:
        raise AssertionError("the step-20 checkpoint did not restore bit for bit")
    if [h["step"] for h in hist_b] != list(range(20, steps)) or resume_err > RESUME_RTOL \
            or first_err > RESUME_RTOL:
        raise AssertionError(f"resumed losses off by {resume_err} (first 20: {first_err}), "
                             f"tol {RESUME_RTOL}")
    if any(counts.values()):
        raise AssertionError(f"the training run launched kernels: {counts}")
    return {"gate": gate, "run": row}


# phase 15: tensor-parallel serving.  Two ranks on the visible card(s): NCCL
# where each rank has a card of its own, else gloo (NCCL refuses two ranks
# on one device); a collective that waits longer than TP_TIMEOUT_S fails its
# rank, and the ranks' whole run fails the phase after TP_PHASE_TIMEOUT_S.
TP_RANKS = 2
TP_TIMEOUT_S = 300
TP_PHASE_TIMEOUT_S = 900
TP_MAX_NEW = 16
# the four slots' positions in the phase's decode checks, within its
# max_len of 1024
TP_DECODE_SEQ = [0, 127, 600, 1023]


def join_group(rank: int, world: int, store: str, device_type: str) -> tuple:
    """A spawned rank's start: no TF32; rank ``r`` on ``cuda:(r %
    device_count)`` (the CPU for a rehearsal, one thread a rank); the group
    through ``store`` (NCCL with a card a rank, else gloo), a timeout on
    every collective.  Returns (device, card count, backend)."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device_type == "cuda":
        count = torch.cuda.device_count()
        device = torch.device("cuda", rank % count)
        torch.cuda.set_device(device)
        backend = "nccl" if count >= world else "gloo"
    else:  # a rehearsal of the phase's code on the CPU
        count, device, backend = 0, torch.device("cpu"), "gloo"
        torch.set_num_threads(1)  # the ranks share the host's cores
    dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
    return device, count, backend


def spawn_ranks(target, world: int, tmp: str, plan: dict, what: str) -> tuple:
    """``world`` spawned processes of ``target(rank, world, store, tmp,
    plan)``, each writing ``tmp/rank{rank}.pkl``; any left after
    ``TP_PHASE_TIMEOUT_S`` are killed and the phase fails.  Returns (the
    ranks' results, seconds)."""
    import pickle

    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    ctx = mp.start_processes(target, args=(world, f"{tmp}/store", tmp, plan),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + TP_PHASE_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise AssertionError(f"{what}: the ranks did not finish in "
                                     f"{TP_PHASE_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    ranks = []
    for r in range(world):
        with open(f"{tmp}/rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, time.perf_counter() - t0


def one_device_runs(torch, kernels, models: dict, device) -> tuple:
    """Each fp32 run of a mesh phase on one device first, on phase 15's
    traffic, its weights drawn from seed 0 and freed after.  Returns
    (``{model: (config, engine settings, prompts, arrivals)}``, ``{model:
    tokens, launches, decode steps, COW copies, pool bytes}``)."""
    from repro_torch.models import model as M
    from repro_torch.serve import Engine, EngineConfig

    runs, base = {}, {}
    for name, (cfg, ec) in models.items():
        prompts, arrivals = tp_traffic(cfg.vocab_size)
        params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                               device=device)
        eng = Engine(cfg, params, EngineConfig(**ec), device=device)
        for rid, (p, t) in enumerate(zip(prompts, arrivals)):
            eng.submit(p, TP_MAX_NEW, rid=rid, arrival_step=t)
        _sync(torch, device)
        kernels.reset_launch_counts()
        reqs = eng.run()
        _sync(torch, device)
        base[name] = {"tokens": [list(map(int, r.out_tokens)) for r in reqs],
                      "launches": kernels.launch_counts(), "decode_steps": eng.decode_steps,
                      "cow_copies": eng.kv.cow_copies, "bytes": eng.kv.cache_bytes()}
        runs[name] = (cfg, ec, prompts, arrivals)
        del params, eng
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return runs, base


def rank_run(torch, kernels, eng, prompts, arrivals, device) -> dict:
    """Run this rank's engine on the traffic in step with its peers: the
    counts set to 0 just before the run and read just after; every
    mla_paged_attention_decode call of the run also held against its plain
    version on the same operands (no launch)."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.core import backend as B
    from repro_torch.kernels.paged_attention import mla_decode_plain

    for rid, (p, t) in enumerate(zip(prompts, arrivals)):
        eng.submit(p, TP_MAX_NEW, rid=rid, arrival_step=t)
    errs, real = [], B.mla_paged_attention_decode

    def checked(*args, scale):
        out = real(*args, scale=scale)
        errs.append((out.float() - mla_decode_plain(*args, scale=scale).float()).abs().max())
        return out

    cuda = torch.device(device).type == "cuda"
    B.mla_paged_attention_decode = checked
    try:
        _sync(torch, device)
        dist.barrier()
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        reqs = eng.run()
        _sync(torch, device)
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
    finally:
        B.mla_paged_attention_decode = real
    audit = drained_audit(eng)
    return {"tokens": [list(map(int, r.out_tokens)) for r in reqs], "launches": counts,
            "decode_steps": eng.decode_steps, "engine_steps": eng.step_count,
            "cow_copies": eng.kv.cow_copies,
            "bytes_per_device": eng.kv.cache_bytes_per_device(), "bytes": eng.kv.cache_bytes(),
            "audit": dataclasses.asdict(audit), "wall_s": wall,
            "run_peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else None,
            "mla_calls": len(errs),
            "mla_max_abs_err": float(torch.stack(errs).max()) if errs else None}


def tp_traffic(vocab: int):
    """8 prompts of 64-512 tokens from a numpy seed; prompt 2 is the first
    300 tokens of prompt 0 (a partial tail page: copy-on-write); arrivals
    every 2 engine steps."""
    import numpy as np

    rng = np.random.default_rng(15)
    lens = rng.integers(64, 513, size=8)
    lens[0] = 512
    prompts = [rng.integers(0, vocab, size=(int(n),)).astype(np.int32) for n in lens]
    prompts[2] = prompts[0][:300].copy()
    return prompts, [2 * i for i in range(len(prompts))]


def tp_models(torch) -> dict:
    """The phase's fp32 runs: ``{name: (config, engine settings)}``."""
    import dataclasses

    import repro_torch.configs as C

    dense = dict(n_layers=3, family="dense", n_experts=0, n_shared_experts=0, top_k=0,
                 moe_d_ff=0, first_k_dense=0, mtp_depth=0)
    ec = {"max_seqs": 4, "max_len": 1024, "page_size": 128, "prefill_chunk": 128}
    return {
        "starcoder2-7b": (C.get_config("starcoder2-7b", dtype=torch.float32,
                                       n_layers=CUT_DEPTH["starcoder2-7b"]), ec),
        "deepseek-v3 dense prefix": (dataclasses.replace(
            C.get_config("deepseek-v3-671b", dtype=torch.float32), **dense), ec),
        "granite-moe-3b-a800m": (C.get_config(
            "granite-moe-3b-a800m", dtype=torch.float32,
            n_layers=CUT_DEPTH["granite-moe-3b-a800m"]), dict(ec, chunked_prefill=False)),
    }


def _sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def tp_engine(torch, cfg, ec, mesh, device):
    """This rank's engine: the full weights drawn from seed 0 on ``device``
    (the single-device run's), its shards kept, the full tree freed.  The
    ranks take turns, so the card never holds more than one full tree."""
    import torch.distributed as dist

    from repro_torch.models import model as M
    from repro_torch.serve import Engine, EngineConfig

    eng = None
    for turn in range(dist.get_world_size()):
        if turn == dist.get_rank():
            params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                                   device=device)
            eng = Engine(cfg, params, EngineConfig(**ec), mesh=mesh, device=device)
            del params
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    return eng


def tp_decode_shapes(models: dict) -> dict:
    """The whole-head decode shapes of the phase's runs, ``{name: (kernel,
    shape)}``: paged_attention_decode's ``(B, H, Hkv, dh, page, maxp)`` for
    a GQA model, mla_paged_attention_decode's ``(B, H, r, dr, page, maxp)``
    for an MLA one, B and maxp from the run's engine settings.  A rank's
    shape has H / M query heads and, GQA, Hkv / M kv heads."""
    out = {}
    for name, (cfg, ec) in models.items():
        page = ec["page_size"]
        maxp = -(-ec["max_len"] // page)
        if cfg.attn_type == "mla":
            out[name] = ("mla_paged_attention_decode", (ec["max_seqs"], cfg.n_heads,
                         cfg.kv_lora_rank, cfg.qk_rope_dim, page, maxp))
        else:
            out[name] = ("paged_attention_decode", (ec["max_seqs"], cfg.n_heads,
                         cfg.n_kv_heads, cfg.d_head, page, maxp))
    return out


def tp_rank_shape(shape, kernel: str, world: int) -> tuple:
    """A rank's share of a whole-head decode shape (:func:`tp_decode_shapes`)."""
    B, H, x, y, page, maxp = shape
    if kernel == "paged_attention_decode":
        return (B, H // world, x // world, y, page, maxp)
    return (B, H // world, x, y, page, maxp)


def tp_head_slices(torch, rank: int, world: int, device, shapes: dict) -> dict:
    """One launch of each paged kernel on this rank's heads at each of the
    phase's decode shapes (``shapes``, :func:`tp_decode_shapes`; fp32 and
    bf16) against the head slice of the same kernel's launch on every
    head, and paged_copy on the rank's pool slice against the slice of the
    whole copy: bit for bit.  Launches made here are not the main path's.
    ``{dtype: {model: {kernel: equal}}}``."""
    from repro_torch.kernels.paged_attention import (
        mla_paged_attention_decode,
        paged_attention_decode,
        paged_copy,
    )

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        gen = torch.Generator(device="cpu").manual_seed(0)  # the same operands on every rank
        out[name] = {}

        def randn(*shape):
            return torch.randn(*shape, generator=gen).to(device, dtype)

        for model, (kernel, (B, H, x, y, page, maxp)) in shapes.items():
            pages = B * maxp + 1
            table = torch.randperm(pages - 1, generator=gen)[:B * maxp].reshape(B, maxp) + 1
            table = table.to(device, torch.int32)
            seq = torch.tensor(TP_DECODE_SEQ, dtype=torch.int32, device=device)
            h = H // world
            heads = slice(rank * h, (rank + 1) * h)
            if kernel == "paged_attention_decode":
                q, kp, vp = randn(B, 1, H, y), randn(pages, page, x, y), randn(pages, page, x, y)
                g = x // world
                kvh = slice(rank * g, (rank + 1) * g)
                full = paged_attention_decode(q, kp, vp, table, seq)
                mine = paged_attention_decode(q[:, :, heads].contiguous(),
                                              kp[:, :, kvh].contiguous(),
                                              vp[:, :, kvh].contiguous(), table, seq)
                pool = randn(2, pages, page, x, y)
                whole = paged_copy(pool.clone(), 3, 5)
                part = paged_copy(pool[:, :, :, kvh].contiguous(), 3, 5)
                out[name][model] = {
                    kernel: bool(torch.equal(mine, full[:, :, heads])),
                    "paged_copy": bool(torch.equal(part, whole[:, :, :, kvh]))}
            else:
                ql, qr = randn(B, 1, H, x), randn(B, 1, H, y)
                ckv, kr = randn(pages, page, x), randn(pages, page, y)
                full = mla_paged_attention_decode(ql, qr, ckv, kr, table, seq, scale=0.0625)
                mine = mla_paged_attention_decode(ql[:, :, heads].contiguous(),
                                                  qr[:, :, heads].contiguous(),
                                                  ckv, kr, table, seq, scale=0.0625)
                out[name][model] = {kernel: bool(torch.equal(mine, full[:, :, heads]))}
    return out


def tp_rank_serve(torch, kernels, cfg, ec, prompts, arrivals, mesh, device) -> dict:
    """One fp32 run on this rank (:func:`rank_run`) on the engine of
    :func:`tp_engine`."""
    eng = tp_engine(torch, cfg, ec, mesh, device)
    res = rank_run(torch, kernels, eng, prompts, arrivals, device)
    del eng
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return res


def tp_rank_timing(torch, cfg16, ec, prompts, arrivals, mesh, device) -> dict:
    """The bf16 decode steps of this rank, one sync per step (the ranks
    step in lockstep: every step's collectives pair them)."""
    eng = tp_engine(torch, cfg16, ec, mesh, device)
    for rid, (p, t) in enumerate(zip(prompts, arrivals)):
        eng.submit(p, TP_MAX_NEW, rid=rid, arrival_step=t)
    decode_ms = []
    while eng.sched.has_work():
        chunks, steps = eng.prefill_chunks, eng.decode_steps
        _sync(torch, device)
        t = time.perf_counter()
        eng.step()
        _sync(torch, device)
        dt = (time.perf_counter() - t) * 1e3
        if eng.prefill_chunks == chunks and eng.decode_steps == steps + 1:
            decode_ms.append(dt)
    eng._flush_pending()
    del eng
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return {"decode_ms": decode_ms}


def tp_rank(rank: int, world: int, store: str, out_dir: str, plan: dict) -> None:
    """One rank of phase 15 (a spawned process): join the group, run the
    kernel head-slice checks, each fp32 model of ``plan``, the bf16 timing;
    write the results to ``out_dir/rank{rank}.pkl``."""
    import pickle

    import torch
    import torch.distributed as dist

    device, count, backend = join_group(rank, world, store, plan["device_type"])
    try:
        import repro_torch.kernels as kernels
        from repro_torch.launch.mesh import make_local_mesh

        mesh = make_local_mesh()  # 1 x world
        out = {"rank": rank, "device": str(device), "backend": backend, "device_count": count,
               "head_slices": tp_head_slices(torch, rank, world, device, plan["shapes"])}
        for name, (cfg, ec, prompts, arrivals) in plan["models"].items():
            out[name] = tp_rank_serve(torch, kernels, cfg, ec, prompts, arrivals, mesh, device)
        cfg16, ec, prompts, arrivals = plan["timing"]
        out["bf16"] = tp_rank_timing(torch, cfg16, ec, prompts, arrivals, mesh, device)
        with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def tp_excused(torch, cfg, prompts, got, want, label, device="cuda") -> list:
    """The ranks' tokens ``got`` against the single-device engine's ``want``
    under the margin rule (and the router rule in a MoE stack) of
    :func:`agree`, the margins stepped along ``want``; the baseline's
    weights are drawn again (seed 0) only if some request diverges."""
    import numpy as np

    from repro_torch.models import model as M
    from repro_torch.serve import ServeConfig, Server

    divs = [(rid, int(np.argmax(np.asarray(g) != np.asarray(w))))
            for rid, (g, w) in enumerate(zip(got, want)) if list(g) != list(w)]
    if not divs:
        return []
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    server = Server(cfg, params, ServeConfig(max_len=2048), device=device)
    excused = []
    for rid, i in divs:
        margin, gaps = margin_at(cfg, params, server, prompts[rid], want[rid], i, device)
        near = [{"step": s, "layer": l, "gap": g} for s, l, g in gaps if g <= ROUTER_GAP]
        if margin < MARGIN:
            excused.append({"rid": rid, "step": i, "rule": "margin", "margin": margin})
        elif near:
            excused.append({"rid": rid, "step": i, "rule": "router", "margin": margin,
                            "near_ties": near})
        else:
            raise AssertionError(f"{label}: request {rid} diverges at step {i} where the "
                                 f"single-device top-2 margin is {margin} >= {MARGIN}")
    del params, server
    return excused


def tp_serve_phase(torch, kernels, device_type: str = "cuda", models=None,
                   timing=None) -> tuple:
    """Phase 15: starcoder2-7b and granite (8 layers each, granite
    expert-parallel) and DeepSeek-V3's dense prefix on a 1 x 2 mesh against
    the single-device engine on the same weights and traffic, then
    starcoder2-7b's bf16 decode steps (32 layers) on the two ranks.  ``device_type``, ``models`` and
    ``timing`` let the same code run at small sizes on the CPU (where the
    kernels' checks against their plain versions do not run).  Returns
    ``({model: its line}, {per-rank decode shape: {dtype: max abs error}})``."""
    import tempfile

    import repro_torch.configs as C

    t_phase = time.perf_counter()
    models = models or tp_models(torch)
    device = device_type
    plan = {"device_type": device_type, "models": {}}
    plan["models"], base = one_device_runs(torch, kernels, models, device)
    cfg16 = timing or C.get_config("starcoder2-7b")
    sc_cfg, sc_ec, sc_prompts, sc_arrivals = plan["models"]["starcoder2-7b"]
    plan["timing"] = (cfg16, sc_ec, sc_prompts, sc_arrivals)
    plan["shapes"] = tp_decode_shapes(models)
    # paged_attention_decode at each rank's decode shape against its plain
    # version, as at every other serving run's shape (MLA: each call of the
    # ranks' runs against its plain version, below)
    checked = {}
    for name, (kernel, shape) in plan["shapes"].items():
        if kernel == "paged_attention_decode" and device_type == "cuda":
            rank_shape = tp_rank_shape(shape, kernel, TP_RANKS)
            checked[f"{name} per rank of 1 x {TP_RANKS} {list(rank_shape)}"] = \
                paged_decode_checks(torch, rank_shape, TP_DECODE_SEQ,
                                    f"{name} per rank of 1 x {TP_RANKS}")
    base_s = time.perf_counter() - t_phase

    with tempfile.TemporaryDirectory() as tmp:
        ranks, ranks_s = spawn_ranks(tp_rank, TP_RANKS, tmp, plan, "tp_serve")
    emit({"phase": "tp_serve", "ranks": TP_RANKS, "backend": ranks[0]["backend"],
          "device_count": ranks[0]["device_count"],
          "rank_devices": [rk["device"] for rk in ranks]})
    for rk in ranks:
        emit({"phase": "tp_serve", "rank": rk["rank"],
              "check": "one launch on the rank's heads == the head slice of the launch on "
                       "every head, bit for bit (paged_copy: the rank's pool slice)",
              "shapes": {name: [kernel, list(shape)]
                         for name, (kernel, shape) in plan["shapes"].items()},
              "seq_pos": TP_DECODE_SEQ, "equal": rk["head_slices"]})
        if not all(ok for by_model in rk["head_slices"].values()
                   for by_kernel in by_model.values() for ok in by_kernel.values()):
            raise AssertionError(f"rank {rk['rank']}: a kernel on its heads is not the head "
                                 f"slice: {rk['head_slices']}")

    result = {}
    for name, (cfg, ec, prompts, arrivals) in plan["models"].items():
        mine = [rk[name] for rk in ranks]
        if any(m["tokens"] != mine[0]["tokens"] for m in mine):
            raise AssertionError(f"{name}: the ranks sampled different tokens")
        excused = tp_excused(torch, cfg, prompts, mine[0]["tokens"], base[name]["tokens"],
                             f"{name} on 2 ranks vs one device", device)
        b = base[name]
        line = {"phase": "tp_serve", "model": name, "run": "fp32, 1 x 2 mesh",
                "layers": cfg.n_layers, "requests": len(prompts),
                "prompt_lens": [len(p) for p in prompts], "of": TP_MAX_NEW,
                "excused": excused_counts(excused), "excused_divergences": excused,
                "decode_steps": [m["decode_steps"] for m in mine],
                "decode_steps_one_device": b["decode_steps"],
                "launches_per_rank": [m["launches"] for m in mine],
                "launches_one_device": b["launches"],
                "pool_bytes_per_rank": [m["bytes_per_device"] for m in mine],
                "pool_bytes_one_device": b["bytes"],
                "cow_copies": [m["cow_copies"] for m in mine],
                "wall_s": [m["wall_s"] for m in mine]}
        if cfg.attn_type == "mla":
            line["mla_calls_per_rank"] = [m["mla_calls"] for m in mine]
            line["mla_max_abs_err_vs_plain"] = max(
                (m["mla_max_abs_err"] for m in mine if m["mla_calls"]), default=None)
        emit(line)
        kernel = "mla_paged_attention_decode" if cfg.attn_type == "mla" else \
            "paged_attention_decode"
        for m in mine:
            if m["decode_steps"] != b["decode_steps"]:
                raise AssertionError(f"{name}: {m['decode_steps']} decode steps on a rank, "
                                     f"{b['decode_steps']} on one device")
            if device_type != "cuda":
                continue
            if m["launches"][kernel] != cfg.n_layers * m["decode_steps"]:
                raise AssertionError(f"{name}: {kernel} launched {m['launches'][kernel]} "
                                     f"times on a rank, not {cfg.n_layers} x "
                                     f"{m['decode_steps']}")
            for k in (kernel, "paged_copy"):
                if m["launches"][k] != b["launches"][k]:
                    raise AssertionError(f"{name}: {k} launched {m['launches'][k]} times on "
                                         f"a rank, {b['launches'][k]} on one device")
            others = {k: n for k, n in m["launches"].items()
                      if n and k not in (kernel, "paged_copy")}
            if others:
                raise AssertionError(f"{name}: other kernels launched: {others}")
        sharded = cfg.attn_type != "mla"  # GQA pools head-shard; MLA latents replicate
        want = b["bytes"] // TP_RANKS if sharded else b["bytes"]
        if any(m["bytes_per_device"] != want for m in mine) or \
                (sharded and b["bytes"] % TP_RANKS):
            raise AssertionError(f"{name}: pool bytes per rank "
                                 f"{[m['bytes_per_device'] for m in mine]}, want {want}")
        if cfg.attn_type == "mla":  # every call of the run held against plain
            if any(m["mla_calls"] != cfg.n_layers * m["decode_steps"] for m in mine):
                raise AssertionError(f"{name}: {line['mla_calls_per_rank']} MLA decodes "
                                     f"checked, not {cfg.n_layers} a step")
            if line["mla_max_abs_err_vs_plain"] > PAGED_TOL:
                raise AssertionError(f"{name}: MLA decode vs plain "
                                     f"{line['mla_max_abs_err_vs_plain']} > {PAGED_TOL}")
        if name == "starcoder2-7b" and mine[0]["cow_copies"] < 1:
            raise AssertionError("starcoder2-7b: no copy-on-write on the ranks")
        result[name] = line

    steps = sorted(ranks[0]["bf16"]["decode_ms"])
    emit({"phase": "tp_serve", "model": cfg16.name, "run": "bf16 timed",
          "label": "2 ranks on one card" if ranks[0]["device_count"] == 1
          else f"2 ranks on {ranks[0]['device_count']} cards",
          "backend": ranks[0]["backend"], "layers": cfg16.n_layers,
          "decode_steps_timed": len(steps),
          "decode_step_ms_median": statistics.median(steps) if steps else None,
          "decode_step_ms_p90": steps[int(0.9 * (len(steps) - 1))] if steps else None,
          "note": "not a tensor-parallel speed-up: both ranks share the card"})
    emit({"phase": "tp_serve", "one_device_s": base_s, "ranks_s": ranks_s})
    return result, checked


# phase 16: training on a data x model mesh, two ranks spawned as in phase
# 15.  minicpm-2b at full width and 4 layers, fp32, batch 2 x 128, 3 steps
# at a constant learning rate (the parameter gate's bound for elements
# whose gradient lies near zero is 2.5 x the summed rates, as in phase 14).
TT_LAYERS = 4
TT_BATCH = (2, 128)
TT_STEPS = 3
TT_LR = 1e-4
TT_MESHES = ("2x1", "1x2")


def tt_config(torch):
    import repro_torch.configs as C

    return C.get_config("minicpm-2b", dtype=torch.float32, n_layers=TT_LAYERS)


def tt_trainer(torch, cfg, mesh, device, ckpt=None):
    from repro_torch.optim import OptConfig
    from repro_torch.train import Trainer, TrainerConfig

    tc = TrainerConfig(steps=TT_STEPS, checkpoint_every=0, log_every=1, checkpoint_dir=ckpt)
    return Trainer(cfg, mesh, tc, OptConfig(lr=TT_LR), lambda step: TT_LR, device=device)


def tt_data(cfg):
    from repro_torch.data import SyntheticLMData

    return SyntheticLMData(cfg, global_batch=TT_BATCH[0], seq_len=TT_BATCH[1])


def tt_single(torch, kernels, cfg, device, out_dir) -> dict:
    """The single-device Trainer on the card: its losses; its final
    parameters and, per leaf, the elements whose gradient lay within
    ``TRAIN_GRAD_TOL`` of the leaf's max |g| at some step, saved under
    ``out_dir`` (numpy, flatten order) for the ranks' gate."""
    import numpy as np

    from repro_torch import tree as T
    from repro_torch.train import loop

    tr = tt_trainer(torch, cfg, None, device)
    near, real = [], loop.adamw_update

    def spy(grads, *args, **kw):  # the step's gradients, as AdamW gets them
        masks = [g.abs() <= TRAIN_GRAD_TOL * g.abs().max() for g in T.leaves(grads)]
        near[:] = masks if not near else [a | b for a, b in zip(near, masks)]
        return real(grads, *args, **kw)

    loop.adamw_update = spy
    kernels.reset_launch_counts()
    try:
        t = time.perf_counter()
        params, opt, hist = tr.fit(tt_data(cfg))
        _sync(torch, device)
        seconds = time.perf_counter() - t
    finally:
        loop.adamw_update = real
    counts = kernels.launch_counts()
    for i, (p, m) in enumerate(zip(T.leaves(params), near)):
        np.save(f"{out_dir}/param_{i:05d}.npy", p.cpu().numpy())
        np.save(f"{out_dir}/near_{i:05d}.npy", m.cpu().numpy())
    out = {"losses": [h["loss"] for h in hist], "launches": counts, "fit_s": seconds,
           "parameters": sum(p.numel() for p in T.leaves(params)),
           "param_bytes": sum(p.numel() * p.element_size() for p in T.leaves(params))}
    del params, opt, near, tr
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def tt_full_shape(local, spec, sizes) -> tuple:
    return tuple(n * math.prod(sizes[a] for a in ((e,) if isinstance(e, str) else e or ()))
                 for n, e in zip(local.shape, tuple(spec) + (None,) * local.dim()))


def tt_rank_run(torch, kernels, cfg, spec, device, single_dir, ckpt) -> dict:
    """One mesh's run on this rank: fit from the seed, the gates' numbers
    (the parameters gathered against the single device's; with ``ckpt``
    the checkpoint restored on one device against the gathered state)."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch import tree as T
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed.sharding import gather_full, split_ways
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(spec)
    rank0 = dist.get_rank() == 0
    tr = tt_trainer(torch, cfg, mesh, device, ckpt)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _sync(torch, device)
    dist.barrier()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    params, opt, hist = tr.fit(tt_data(cfg))
    _sync(torch, device)
    fit_s = time.perf_counter() - t
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" \
        else None
    lay = tr.layout
    specs = T.leaves(lay.shardings(params))

    def nbytes_of(tree):
        return sum(x.numel() * x.element_size() for x in T.leaves(tree))

    share = 0
    for x, sh in zip(T.leaves(params), specs):
        full = math.prod(tt_full_shape(x, sh.spec, lay.sizes))
        share += full * x.element_size() // split_ways(sh.spec, lay.sizes)
    # the parameters gathered, against the single device's (rank 0 holds them)
    param_err, beyond = 0.0, 0.0
    for i, (x, sh) in enumerate(zip(T.leaves(params), specs)):
        full = gather_full(x, sh.spec, mesh)
        if rank0:
            want = torch.from_numpy(np.load(f"{single_dir}/param_{i:05d}.npy")).to(device)
            near = torch.from_numpy(np.load(f"{single_dir}/near_{i:05d}.npy")).to(device)
            diff = (full - want).abs()
            if (~near).any():
                param_err = max(param_err, diff[~near].max().item())
            if near.any():
                beyond = max(beyond, diff[near].max().item())
            del want, near, diff
        del full
    restored_equal = None
    if ckpt is not None:  # fit's closing save: the logical leaves
        state = (params, opt)
        like, full_specs = [], T.leaves(lay.shardings(state))
        for x, sh in zip(T.leaves(state), full_specs):
            like.append(torch.empty(tt_full_shape(x, sh.spec, lay.sizes), dtype=x.dtype,
                                    device=device) if rank0 else None)
        restored = None
        if rank0:
            _, restored = CheckpointManager(ckpt).restore(T.unflatten(state, like),
                                                          step=TT_STEPS, device=device)
            del like
        restored_equal = True
        for i, (x, sh) in enumerate(zip(T.leaves(state), full_specs)):
            full = gather_full(x, sh.spec, mesh)
            if rank0:
                restored_equal &= bool(torch.equal(full, T.leaves(restored)[i]))
            del full
        del restored
    out = {"mesh": spec, "losses": [h["loss"] for h in hist], "launches": counts,
           "fit_s": fit_s, "step_ms": [h["s"] * 1e3 for h in hist],
           "resident_bytes": nbytes_of((params, opt)), "param_bytes": nbytes_of(params),
           "moment_bytes": nbytes_of((opt["m"], opt["v"])),
           "param_bytes_by_spec": share, "max_memory_allocated": peak,
           "param_max_abs_err": param_err if rank0 else None,
           "near_zero_max_abs_err": beyond if rank0 else None,
           "checkpoint_restored_bit_exact": restored_equal if rank0 else None}
    del params, opt, tr
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    dist.barrier()
    return out


def tt_rank(rank: int, world: int, store: str, out_dir: str, plan: dict) -> None:
    """One rank of phase 16 (a spawned process): join the group (NCCL with a
    card a rank, else gloo), run each mesh of ``TT_MESHES``, write the
    results to ``out_dir/rank{rank}.pkl``."""
    import pickle

    import torch
    import torch.distributed as dist

    device, count, backend = join_group(rank, world, store, plan["device_type"])
    try:
        import repro_torch.kernels as kernels
        from repro_torch.distributed import sharding

        if plan["replicate_below"] is not None:  # the CPU rehearsal's small model
            sharding.REPLICATE_BELOW = plan["replicate_below"]
        out = {"rank": rank, "device": str(device), "backend": backend, "device_count": count}
        for spec in TT_MESHES:
            ckpt = f"{out_dir}/ckpt_{spec}" if spec == "2x1" else None
            out[spec] = tt_rank_run(torch, kernels, plan["cfg"], spec, device,
                                    plan["single_dir"], ckpt)
        with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def tp_train_phase(torch, kernels, device_type: str = "cuda", cfg=None,
                   replicate_below=None) -> dict:
    """Phase 16: the single-device Trainer, then two ranks on a ``2 x 1``
    and a ``1 x 2`` mesh from the same seed and batches; the gates of the
    module docstring.  ``device_type``, ``cfg`` and ``replicate_below`` (the
    ranks' ``REPLICATE_BELOW``, for a model smaller than it) let the same
    code run at a small size on the CPU.  Returns ``{mesh: its line}``."""
    import tempfile


    t_phase = time.perf_counter()
    cfg = cfg or tt_config(torch)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_train_") as tmp:
        os.makedirs(f"{tmp}/single")
        single = tt_single(torch, kernels, cfg, device_type, f"{tmp}/single")
        emit({"phase": "tp_train", "model": cfg.name, "run": "fp32, one device",
              "layers": cfg.n_layers, "batch": list(TT_BATCH), "steps": TT_STEPS, **single})
        if any(single["launches"].values()):
            raise AssertionError(f"the single-device training launched kernels: "
                                 f"{single['launches']}")
        plan = {"device_type": device_type, "cfg": cfg, "single_dir": f"{tmp}/single",
                "replicate_below": replicate_below}
        ranks, ranks_s = spawn_ranks(tt_rank, TP_RANKS, tmp, plan, "tp_train")
    count, backend = ranks[0]["device_count"], ranks[0]["backend"]
    label = (f"{TP_RANKS} ranks on the CPU ({backend})" if count == 0
             else f"{TP_RANKS} ranks on one card ({backend})" if count < TP_RANKS
             else f"{TP_RANKS} ranks on {TP_RANKS} cards ({backend})")
    lr_sum = TT_LR * TT_STEPS
    result = {}
    for spec in TT_MESHES:
        mine = [rk[spec] for rk in ranks]
        rel = max(abs(a - b) / abs(b) for m in mine
                  for a, b in zip(m["losses"], single["losses"]))
        line = {"phase": "tp_train", "model": cfg.name, "mesh": spec,
                "run": "fp32, " + ("DP + ZeRO" if spec == "2x1" else "TP"),
                "backend": ranks[0]["backend"], "rank_devices": [rk["device"] for rk in ranks],
                "losses_per_rank": [m["losses"] for m in mine],
                "losses_one_device": single["losses"], "loss_max_rel_err": rel,
                "param_max_abs_err": mine[0]["param_max_abs_err"],
                "near_zero_grad_max_abs_err": mine[0]["near_zero_max_abs_err"],
                "near_zero_bound": 2.5 * lr_sum,
                "resident_bytes_per_rank": [m["resident_bytes"] for m in mine],
                "param_bytes_per_rank": [m["param_bytes"] for m in mine],
                "moment_bytes_per_rank": [m["moment_bytes"] for m in mine],
                "param_bytes_by_spec": [m["param_bytes_by_spec"] for m in mine],
                "param_bytes_one_device": single["param_bytes"],
                "max_memory_allocated_per_rank": [m["max_memory_allocated"] for m in mine],
                "launches_per_rank": [m["launches"] for m in mine],
                "fit_s_per_rank": [m["fit_s"] for m in mine],
                "step_ms_per_rank": [m["step_ms"] for m in mine],
                "step_ms_label": label}
        if spec == "2x1":
            line["checkpoint_restored_on_one_device_bit_exact"] = \
                mine[0]["checkpoint_restored_bit_exact"]
        emit(line)
        if any(m["losses"] != mine[0]["losses"] for m in mine):
            raise AssertionError(f"tp_train {spec}: the ranks logged different losses")
        if rel > TRAIN_LOSS_RTOL:
            raise AssertionError(f"tp_train {spec}: losses {rel} relative off the single "
                                 f"device's (tol {TRAIN_LOSS_RTOL})")
        if line["param_max_abs_err"] > TRAIN_PARAM_TOL or \
                line["near_zero_grad_max_abs_err"] > 2.5 * lr_sum:
            raise AssertionError(f"tp_train {spec}: parameters {line['param_max_abs_err']} "
                                 f"(tol {TRAIN_PARAM_TOL}), near-zero-gradient elements "
                                 f"{line['near_zero_grad_max_abs_err']} (bound {2.5 * lr_sum})")
        for m in mine:
            if m["param_bytes"] != m["param_bytes_by_spec"] or \
                    m["moment_bytes"] != 2 * m["param_bytes"]:
                raise AssertionError(f"tp_train {spec}: a rank holds {m['param_bytes']} "
                                     f"parameter and {m['moment_bytes']} moment bytes; its "
                                     f"specs give {m['param_bytes_by_spec']}")
            if m["param_bytes"] >= single["param_bytes"]:
                raise AssertionError(f"tp_train {spec}: a rank holds every parameter")
            if any(m["launches"].values()):
                raise AssertionError(f"tp_train {spec}: kernels launched: {m['launches']}")
        if spec == "2x1" and line["checkpoint_restored_on_one_device_bit_exact"] is not True:
            raise AssertionError("tp_train: the 2 x 1 checkpoint did not restore bit for bit "
                                 "on one device")
        result[spec] = line
    emit({"phase": "tp_train", "one_device_s": single["fit_s"], "ranks_s": ranks_s,
          "phase_s": time.perf_counter() - t_phase})
    return result


# phase 17: serving on a data x model mesh, four ranks spawned as in phase
# 15 on a 2 x 2 mesh, each drawing its shards of the JAX serve mode's
# resident weights from the seed (no rank holds the full tree), on phase
# 15's models.
DP_MESH = "2x2"
DP_RANKS = 4
DP_MODEL_AXIS = 2
# a rank's transient while loading, beyond its shares and one full unit
# (the caching allocator's rounding, a piece being cut)
DP_LOAD_SLACK = 256 << 20


def dp_load_units(cfg) -> tuple:
    """(bytes of the full tree, bytes of its largest unit a rank draws whole
    while loading by shards: one leaf outside the layer stacks, or one
    layer of a stack) of ``cfg``'s parameters."""
    import torch

    from repro_torch.models import model as M

    size = torch.empty((), dtype=cfg.dtype).element_size()
    shapes = M.param_shapes(cfg)
    total, unit = 0, 0
    for key, sub in shapes.items():
        leaves = [s for _p, s in _flat_shapes(sub)]
        n = sum(math.prod(s) for s in leaves) * size
        total += n
        if M.is_layer_stack(key):
            unit = max(unit, n // leaves[0][0])
        else:
            unit = max(unit, max(math.prod(s) for s in leaves) * size)
    return total, unit


def _flat_shapes(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_shapes(v, path + (k,))
    else:
        yield path, tree


def dp_rank_serve(torch, kernels, cfg, ec, prompts, arrivals, mesh, device) -> dict:
    """One fp32 run on this rank (:func:`rank_run`): its shards drawn from
    seed 0 (the single-device run's numbers), the peak while loading, the
    bytes it stores against the serve spec's share, and the engine built
    on the tree as drawn."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import model as M
    from repro_torch.serve import Engine, EngineConfig

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        base_alloc = torch.cuda.memory_allocated(device)
    t0 = time.perf_counter()
    layout = SH.ServeLayout(cfg, mesh)
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device,
                           layout=layout)
    _sync(torch, device)
    load_s = time.perf_counter() - t0
    load_peak = torch.cuda.max_memory_allocated(device) - base_alloc if cuda else None
    leaves = [t for _p, t in SH.flat_items(params)]
    eng = Engine(cfg, params, EngineConfig(**ec), mesh=mesh, device=device)
    kept = all(a is b for (_p, a), b in zip(SH.flat_items(eng.params), leaves))
    res = rank_run(torch, kernels, eng, prompts, arrivals, device)
    res.update(load_s=load_s, load_peak_bytes=load_peak, placed_tree_kept=kept,
               param_bytes=sum(t.numel() * t.element_size() for t in leaves),
               param_bytes_by_spec=layout.share_nbytes(params),
               gathered_each_step=layout.gathered())
    del eng, params, leaves
    if cuda:
        torch.cuda.empty_cache()
    return res


def dp_rank(rank: int, world: int, store: str, out_dir: str, plan: dict) -> None:
    """One rank of phase 17 (a spawned process): join the group, build the
    ``2 x 2`` mesh, run phase 15's kernel head-slice checks on its model
    slice, then each fp32 model of ``plan``; write the results to
    ``out_dir/rank{rank}.pkl``."""
    import pickle

    import torch
    import torch.distributed as dist

    device, count, backend = join_group(rank, world, store, plan["device_type"])
    try:
        import repro_torch.kernels as kernels
        from repro_torch.distributed.axes import mesh_coords
        from repro_torch.launch.mesh import make_serve_mesh

        mesh = make_serve_mesh(DP_MESH)
        coords = mesh_coords(mesh)
        out = {"rank": rank, "coords": coords, "device": str(device), "backend": backend,
               "device_count": count,
               "head_slices": tp_head_slices(torch, coords["model"], DP_MODEL_AXIS, device,
                                             plan["shapes"])}
        for name, (cfg, ec, prompts, arrivals) in plan["models"].items():
            out[name] = dp_rank_serve(torch, kernels, cfg, ec, prompts, arrivals, mesh, device)
        with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def dp_serve_phase(torch, kernels, device_type: str = "cuda", models=None,
                   checked=None) -> dict:
    """Phase 17: starcoder2-7b (8 layers), DeepSeek-V3's dense prefix and
    granite (8 layers) on a 2 x 2 mesh, four spawned ranks each drawing its
    shards from seed 0, against the single-device engine on the same
    weights and traffic.  ``checked``: phase 15's checks of
    paged_attention_decode against decode_plain at the per-rank decode
    shapes (the same here: the pools sit on a model axis of 2 as there);
    run here where not given.  ``device_type`` and ``models`` let the same
    code run at small sizes on the CPU.  Returns ``{model: its line}``."""
    import tempfile


    t_phase = time.perf_counter()
    models = models or tp_models(torch)
    device = device_type
    plan = {"device_type": device_type, "models": {}, "shapes": tp_decode_shapes(models)}
    plan["models"], base = one_device_runs(torch, kernels, models, device)
    if checked is None and device_type == "cuda":
        checked = {}
        for name, (kernel, shape) in plan["shapes"].items():
            if kernel == "paged_attention_decode":
                rank_shape = tp_rank_shape(shape, kernel, DP_MODEL_AXIS)
                checked[f"{name} per rank of {DP_MESH} {list(rank_shape)}"] = \
                    paged_decode_checks(torch, rank_shape, TP_DECODE_SEQ,
                                        f"{name} per rank of {DP_MESH}")
    base_s = time.perf_counter() - t_phase

    with tempfile.TemporaryDirectory() as tmp:
        ranks, ranks_s = spawn_ranks(dp_rank, DP_RANKS, tmp, plan, "dp_serve")
    count, backend = ranks[0]["device_count"], ranks[0]["backend"]
    label = (f"{DP_RANKS} ranks on the CPU ({backend})" if count == 0
             else f"{DP_RANKS} ranks on one card ({backend})" if count == 1
             else f"{DP_RANKS} ranks on {min(count, DP_RANKS)} cards ({backend})")
    emit({"phase": "dp_serve", "mesh": DP_MESH, "ranks": DP_RANKS, "label": label,
          "backend": backend, "device_count": count,
          "rank_coords": [rk["coords"] for rk in ranks],
          "rank_devices": [rk["device"] for rk in ranks],
          "kernel_checks_vs_plain": sorted(checked or {})})
    for rk in ranks:
        emit({"phase": "dp_serve", "rank": rk["rank"], "coords": rk["coords"],
              "check": "one launch on the model slice's heads == the head slice of the "
                       "launch on every head, bit for bit (paged_copy: the slice's pool)",
              "equal": rk["head_slices"]})
        if not all(ok for by_model in rk["head_slices"].values()
                   for by_kernel in by_model.values() for ok in by_kernel.values()):
            raise AssertionError(f"rank {rk['rank']}: a kernel on its heads is not the head "
                                 f"slice: {rk['head_slices']}")

    result = {}
    for name, (cfg, ec, prompts, arrivals) in plan["models"].items():
        mine = [rk[name] for rk in ranks]
        b = base[name]
        if any(m["tokens"] != mine[0]["tokens"] for m in mine):
            raise AssertionError(f"{name}: the ranks sampled different tokens")
        excused = tp_excused(torch, cfg, prompts, mine[0]["tokens"], b["tokens"],
                             f"{name} on {DP_MESH} vs one device", device)
        kernel = "mla_paged_attention_decode" if cfg.attn_type == "mla" else \
            "paged_attention_decode"
        b["full_tree_bytes"], b["load_unit_bytes"] = dp_load_units(cfg)
        bound = [m["param_bytes"] + b["load_unit_bytes"] + DP_LOAD_SLACK for m in mine]
        line = {"phase": "dp_serve", "model": name, "run": f"fp32, {DP_MESH} mesh",
                "label": label, "layers": cfg.n_layers, "requests": len(prompts),
                "prompt_lens": [len(p) for p in prompts], "of": TP_MAX_NEW,
                "excused": excused_counts(excused), "excused_divergences": excused,
                "decode_steps": [m["decode_steps"] for m in mine],
                "decode_steps_one_device": b["decode_steps"],
                "engine_steps": [m["engine_steps"] for m in mine],
                "launches_per_rank": [m["launches"] for m in mine],
                "launches_one_device": b["launches"],
                "cow_copies": [m["cow_copies"] for m in mine],
                "param_bytes_per_rank": [m["param_bytes"] for m in mine],
                "param_bytes_by_spec": [m["param_bytes_by_spec"] for m in mine],
                "full_tree_bytes": b["full_tree_bytes"],
                "gathered_each_step": mine[0]["gathered_each_step"],
                "load_peak_bytes_per_rank": [m["load_peak_bytes"] for m in mine],
                "load_peak_bound_bytes": bound,
                "max_memory_allocated_per_rank": [m["run_peak_bytes"] for m in mine],
                "max_memory_allocated_predicted": [
                    m["param_bytes"] + m["bytes_per_device"] for m in mine],
                "pool_bytes_per_rank": [m["bytes_per_device"] for m in mine],
                "pool_bytes_one_device": b["bytes"],
                "load_s": [m["load_s"] for m in mine], "wall_s": [m["wall_s"] for m in mine],
                "engine_steps_per_s": [m["engine_steps"] / m["wall_s"] for m in mine],
                "decode_steps_per_s": [m["decode_steps"] / m["wall_s"] for m in mine]}
        if cfg.attn_type == "mla":
            line["mla_calls_per_rank"] = [m["mla_calls"] for m in mine]
            line["mla_max_abs_err_vs_plain"] = max(
                (m["mla_max_abs_err"] for m in mine if m["mla_calls"]), default=None)
        emit(line)
        for m in mine:
            if m["decode_steps"] != b["decode_steps"]:
                raise AssertionError(f"{name}: {m['decode_steps']} decode steps on a rank, "
                                     f"{b['decode_steps']} on one device")
            if m["param_bytes"] != m["param_bytes_by_spec"] or not m["placed_tree_kept"]:
                raise AssertionError(f"{name}: a rank stores {m['param_bytes']} parameter "
                                     f"bytes, the serve spec's share is "
                                     f"{m['param_bytes_by_spec']} (tree kept: "
                                     f"{m['placed_tree_kept']})")
            if m["param_bytes"] >= b["full_tree_bytes"]:
                raise AssertionError(f"{name}: a rank stores the full tree")
            if device_type != "cuda":
                continue
            if m["load_peak_bytes"] >= b["full_tree_bytes"] or \
                    m["load_peak_bytes"] > m["param_bytes"] + b["load_unit_bytes"] + DP_LOAD_SLACK:
                raise AssertionError(f"{name}: a rank's peak while loading was "
                                     f"{m['load_peak_bytes']} bytes: its shares "
                                     f"{m['param_bytes']}, one unit {b['load_unit_bytes']}, "
                                     f"the full tree {b['full_tree_bytes']}")
            if m["launches"][kernel] != cfg.n_layers * m["decode_steps"]:
                raise AssertionError(f"{name}: {kernel} launched {m['launches'][kernel]} "
                                     f"times on a rank, not {cfg.n_layers} x "
                                     f"{m['decode_steps']}")
            if m["launches"]["paged_copy"] != 2 * m["cow_copies"] or \
                    m["launches"]["paged_copy"] != b["launches"]["paged_copy"]:
                raise AssertionError(f"{name}: paged_copy launched "
                                     f"{m['launches']['paged_copy']} times on a rank for "
                                     f"{m['cow_copies']} COW copies, "
                                     f"{b['launches']['paged_copy']} on one device")
            others = {k: n for k, n in m["launches"].items()
                      if n and k not in (kernel, "paged_copy")}
            if others:
                raise AssertionError(f"{name}: other kernels launched: {others}")
        sharded = cfg.attn_type != "mla"  # GQA pools head-shard; MLA latents replicate
        want = b["bytes"] // DP_MODEL_AXIS if sharded else b["bytes"]
        if any(m["bytes_per_device"] != want for m in mine):
            raise AssertionError(f"{name}: pool bytes per rank "
                                 f"{[m['bytes_per_device'] for m in mine]}, want {want}")
        if cfg.attn_type == "mla":  # every call of the run held against plain
            if any(m["mla_calls"] != cfg.n_layers * m["decode_steps"] for m in mine):
                raise AssertionError(f"{name}: {line['mla_calls_per_rank']} MLA decodes "
                                     f"checked, not {cfg.n_layers} a step")
            if line["mla_max_abs_err_vs_plain"] > PAGED_TOL:
                raise AssertionError(f"{name}: MLA decode vs plain "
                                     f"{line['mla_max_abs_err_vs_plain']} > {PAGED_TOL}")
        if name == "starcoder2-7b" and mine[0]["cow_copies"] < 1:
            raise AssertionError("starcoder2-7b: no copy-on-write on the ranks")
        result[name] = line
    emit({"phase": "dp_serve", "one_device_s": base_s, "ranks_s": ranks_s,
          "phase_s": time.perf_counter() - t_phase})
    return result


# --------------------------------------------------------------------------
# 18. the paper's memory model on the card
# --------------------------------------------------------------------------

MM_SMALL = dict(seq=128, d_model=192, n_heads=3, d_head=64, d_ff=768)
MM_SPEEDUP_BAND = (1.8, 3.8)  # the JAX package's full-size test band
MM_CLOCK_HZ = 2.3e9  # the simulated SoC's CPU clock (paper §4.1)


def memmodel_phase(torch, device: str = "cuda", full=None) -> dict:
    """The memory model on the card against its own CPU run (SMALL: every
    accelerator, layout and core count; full size: SA16x16, both layouts,
    one core), then the paper's full-size figures.  ``device`` and ``full``
    (default the BERT-base layer) let the CPU rehearse the phase."""
    import dataclasses

    from repro_torch.core import memmodel as mm

    small = mm.WorkloadConfig(**MM_SMALL)
    full = full or mm.WorkloadConfig()
    checked = 0
    cases = [(small, a, lay, c) for a in mm.PAPER_ACCELERATORS for lay in ("rwma", "bwma")
             for c in (1, 2, 4)]
    cases += [(full, mm.AccelSpec.sa(16), lay, 1) for lay in ("rwma", "bwma")]
    for wl, accel, layout, cores in cases:
        got = mm.simulate_layer(wl, accel, layout, cores, device=device)
        want = mm.simulate_layer(wl, accel, layout, cores, device="cpu")
        for comp in want:
            if dataclasses.asdict(got[comp]) != dataclasses.asdict(want[comp]):
                raise AssertionError(f"memmodel {accel.name} {layout} cores={cores} "
                                     f"seq={wl.seq} {comp}: card {got[comp]} != cpu "
                                     f"{want[comp]}")
            checked += 1
    emit({"phase": "memmodel_check", "components_equal": checked,
          "cases": len(cases), "full_size": "SA16x16 rwma+bwma, 1 core"})

    _sync(torch, device)
    t0 = time.perf_counter()
    ms = 1e3 / MM_CLOCK_HZ
    res = {a.name: {lay: mm.simulate_layer(full, a, lay, device=device)
                    for lay in ("rwma", "bwma")} for a in mm.PAPER_ACCELERATORS}
    fig6a = {name: {"rwma_ms": r["rwma"]["total"].cycles * ms,
                    "bwma_ms": r["bwma"]["total"].cycles * ms,
                    "speedup": r["rwma"]["total"].cycles / r["bwma"]["total"].cycles,
                    "l1_miss_ratio": r["rwma"]["total"].l1_misses
                    / max(r["bwma"]["total"].l1_misses, 1)}
             for name, r in res.items()}
    sa16 = mm.AccelSpec.sa(16)
    fig6b = {}
    for cores in (1, 2, 4):
        r = mm.simulate_layer(full, sa16, "rwma", cores, device=device)["total"].cycles
        b = mm.simulate_layer(full, sa16, "bwma", cores, device=device)["total"].cycles
        fig6b[cores] = {"rwma_ms": r * ms, "bwma_ms": b * ms, "speedup": r / b}
    r16 = res[sa16.name]
    fig7 = {lay: sum(r16[lay][c].cycles for c in mm.GEMM_COMPONENTS) / r16[lay]["total"].cycles
            for lay in ("rwma", "bwma")}
    fig8 = {f: [getattr(r16["rwma"]["total"], f), getattr(r16["bwma"]["total"], f)]
            for f in ("l1_misses", "l2_accesses", "dram_accesses", "addr_cycles")}
    conversion = mm.conversion_overhead_fraction(full, sa16, device=device)
    _sync(torch, device)
    seconds = time.perf_counter() - t0
    speed = fig6a[sa16.name]["speedup"]
    lo, hi = MM_SPEEDUP_BAND
    if not lo < speed < hi:
        raise AssertionError(f"memmodel: SA16x16 single-core speedup {speed} outside {lo}-{hi}")
    emit({"phase": "memmodel", "workload": dataclasses.asdict(full),
          "fig6a": fig6a, "fig6b": fig6b, "fig7_gemm_share": fig7,
          "fig8_rwma_bwma": fig8, "conversion_fraction_12_layers": conversion,
          "sa16_speedup_band": list(MM_SPEEDUP_BAND),
          "model_seconds": seconds, "model_device": device,
          "trace_lines": {name: {lay: sum(t.numel() for _n, t, _m in mm.bert_layer_components(
              full, a, lay, device="meta")) for lay in ("rwma", "bwma")}
              for name, a in ((a.name, a) for a in mm.PAPER_ACCELERATORS)}})
    return fig6a


# --------------------------------------------------------------------------
# 19. the dry run on one device, held against a real run
# --------------------------------------------------------------------------

DRYRUN_ARCH = "mamba2-130m"
DRYRUN_FIT = 0.5  # the share of the card a real run's predicted peak may take


def _real_args(torch, cfg, kind: str, rows: int, seq: int, device: str):
    """The arguments of the dry run's one-device step, on the card with
    numbers: weights from seed 0, an empty cache, seeded tokens."""
    from repro_torch.models import model as M

    gen = torch.Generator(device=device).manual_seed(0)
    params = M.init_params(cfg, gen, device=device)
    if kind == "decode":
        tokens = torch.randint(0, cfg.vocab_size, (rows, 1), generator=gen,
                               device=device, dtype=torch.int32)
        return (params, M.init_cache(cfg, rows, seq, device=device), tokens)
    tokens = torch.randint(0, cfg.vocab_size, (rows, seq), generator=gen, device=device,
                           dtype=torch.int32)
    return (params, {"tokens": tokens})


def dryrun_phase(torch, device: str = "cuda", cfg=None, budget=None) -> dict:
    """mamba2-130m's decode_32k and prefill_32k on a 1 x 1 mesh: traced on
    the meta device, then the same step once on the card.  ``device``,
    ``cfg`` (default the full config) and ``budget`` (default half the
    card's memory) let the CPU rehearse the phase."""
    from torch.utils.flop_counter import FlopCounterMode

    import repro_torch.configs as C
    from repro_torch.analysis.aot import argument_bytes, trace_step
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import dryrun as D

    cfg = cfg or C.get_config(DRYRUN_ARCH)
    if budget is None:
        budget = DRYRUN_FIT * torch.cuda.get_device_properties(0).total_memory
    out = {}
    for shape in ("decode_32k", "prefill_32k"):
        shp = SHAPES[shape]
        fn, args, _info = D.build_cell(cfg, shape, None)
        t0 = time.perf_counter()
        art = trace_step(fn, args)
        full_peak = art.memory["argument_size_in_bytes"] + art.memory["temp_size_in_bytes"]
        rows = shp.global_batch
        if full_peak > budget:  # the cell's rows cut to fit, by the prediction
            while rows > 1 and full_peak * rows / shp.global_batch > budget:
                rows //= 2
            fn, args, _info = D.build_cell(cfg, shape, None, rows=rows)
            art = trace_step(fn, args)
        trace_s = time.perf_counter() - t0
        real = _real_args(torch, cfg, "decode" if shp.kind == "decode" else "prefill", rows,
                          shp.seq_len, device)
        _sync(torch, device)
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        counter = FlopCounterMode(display=False)
        t0 = time.perf_counter()
        with counter:
            logits, _caches = fn(*real)
        _sync(torch, device)
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
        predicted = art.memory["argument_size_in_bytes"] + art.memory["temp_size_in_bytes"]
        row = {"cell": f"{cfg.name} x {shape} x 1x1", "rows": rows,
               "rows_of_cell": shp.global_batch,
               "argument_bytes": art.memory["argument_size_in_bytes"],
               "real_argument_bytes": argument_bytes(real),
               "flops": art.flops, "real_flops": int(counter.get_total_flops()),
               "collectives": art.collectives["count"],
               "predicted_peak_bytes": predicted, "max_memory_allocated": peak,
               "full_cell_predicted_peak_bytes": full_peak,
               "trace_s": trace_s, "real_run_s": run_s}
        emit({"phase": "dryrun_cell", **row})
        if row["argument_bytes"] != row["real_argument_bytes"]:
            raise AssertionError(f"dryrun {shape}: argument bytes {row['argument_bytes']} != "
                                 f"real {row['real_argument_bytes']}")
        if row["flops"] != row["real_flops"]:
            raise AssertionError(f"dryrun {shape}: FLOPs {row['flops']} != real "
                                 f"{row['real_flops']}")
        if row["collectives"]:
            raise AssertionError(f"dryrun {shape}: {row['collectives']} collectives on 1 x 1")
        if tuple(logits.shape) != (rows, 1, cfg.padded_vocab) or \
                not torch.isfinite(logits[..., :cfg.vocab_size].float()).all():
            raise AssertionError(f"dryrun {shape}: logits {tuple(logits.shape)} not finite")
        out[shape] = row
        del real, logits, _caches
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# 20. the analysis tools on the card: torchcheck's inventory and the sync guard
# --------------------------------------------------------------------------

AN_ARCH = "minicpm-2b"
AN_SERVE_PROMPTS = (40, 23, 57)  # prompt lengths of the guarded engine's requests
AN_SERVE_NEW = 16


def _wide_conversions(steps, widest: int = 4) -> dict:
    """{step: [from -> to, ...]} of every conversion wider than ``widest``
    bytes (what RPJ103 reads)."""
    out = {}
    for ts in steps:
        pairs = sorted({(c["from"], c["to"]) for c in ts.conversions
                        if c["to_itemsize"] > widest})
        if pairs:
            out[ts.name] = pairs
    return out


def _inventory_rows(steps) -> dict:
    from repro_torch.analysis.torchcheck.harness import measure

    return {ts.name: {**measure(ts), "launches": ts.launches,
                      "device_peak_above_args": ts.memory.get("device_peak_above_args")}
            for ts in steps}


def _placement_storages(torch, device: str) -> dict:
    """Each rank of a ``1 x 2`` serve mesh places minicpm-2b smoke weights
    drawn on the device (``"cuda:0"`` on the card) onto ``device`` (plain
    ``"cuda"``): {rank: the placed bytes, their storages' bytes, the leaves
    that are views of a larger storage}."""
    import repro_torch.configs as C
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.axes import abstract_mesh
    from repro_torch.models import model as M

    cfg = C.get_config(AN_ARCH, smoke=True, dtype=torch.float32)
    here = torch.device(device)
    if here.type == "cuda":
        here = torch.device("cuda", torch.cuda.current_device())
    full = M.init_params(cfg, torch.Generator(device=here).manual_seed(0), device=here)
    mesh = abstract_mesh((1, 2), ("data", "model"))
    out = {}
    for rank in range(2):
        layout = SH.ServeLayout(cfg, mesh, coords={"data": 0, "model": rank})
        leaves = list(SH.flat_items(layout.place(full, torch.device(device))))
        storages = {t.untyped_storage()._cdata: t.untyped_storage().nbytes() for _, t in leaves}
        out[rank] = {
            "bytes": sum(t.numel() * t.element_size() for _, t in leaves),
            "storage_bytes": sum(storages.values()),
            "views": ["/".join(path) for path, t in leaves
                      if t.untyped_storage().nbytes() != t.numel() * t.element_size()]}
    return out


def analysis_phase(torch, device: str = "cuda", full: bool = True) -> dict:
    """torchcheck's inventory on the card at the checked-in geometry (a),
    then at minicpm-2b's full width (b), then a full-width engine served
    under the sync guard against an unguarded one (c), then a ``1 x 2``
    rank's placed weights (d).  ``device`` and ``full=False`` (the smoke
    config in (b) and (c)) let the CPU rehearse the phase."""
    import numpy as np

    import repro_torch.configs as C
    from repro_torch.analysis.torchcheck import load_budgets
    from repro_torch.analysis.torchcheck.harness import guarded, trace
    from repro_torch.analysis.torchcheck.inventory import InventoryConfig, serving_inventory
    from repro_torch.analysis.torchcheck.rules import run_rules
    from repro_torch.serve.engine import Engine, EngineConfig
    from repro_torch.models import model as M

    budgets = load_budgets(ROOT / "torchcheck.budgets")
    on_card = torch.device(device).type == "cuda"
    out = {}

    # (a) the checked-in geometry against torchcheck.budgets
    t0 = time.perf_counter()
    with serving_inventory(InventoryConfig(device=device)) as inv:
        steps = [trace(spec) for spec in inv.specs]
        findings = run_rules(steps, inv, budgets)
        left_out = dict(inv.left_out)
    rows = _inventory_rows(steps)
    twins = {name: all(rows[name][k] == budgets.budget(name, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes", "max_gather_bytes",
        "alias_size_in_bytes")) for name in rows if budgets.budget(name, "argument_size_in_bytes")}
    out["smoke"] = {"steps": rows, "findings": [f.format() for f in findings],
                    "left_out": left_out, "equal_to_budgets": twins,
                    "wide_conversions": _wide_conversions(steps),
                    "seconds": time.perf_counter() - t0}
    emit({"phase": "analysis", "part": "a: torchcheck at the checked-in geometry",
          "device": device, **out["smoke"]})
    if findings:
        raise AssertionError("analysis (a): torchcheck findings:\n" + "\n".join(
            f.format() for f in findings))
    if not all(twins.values()):
        raise AssertionError(f"analysis (a): argument, output, gather or in-place bytes "
                             f"differ from torchcheck.budgets: {twins}")
    if on_card:
        if left_out:
            raise AssertionError(f"analysis (a): steps left out on the card: {left_out}")
        for name, kernel in (("decode_step", "paged_attention_decode"),
                             ("cow_copy", "paged_copy")):
            if not rows[name]["launches"].get(kernel):
                raise AssertionError(f"analysis (a): {name} launched no {kernel}: "
                                     f"{rows[name]['launches']}")
    for name, row in rows.items():
        if name.endswith("_reference") and row["launches"]:
            raise AssertionError(f"analysis (a): {name} launched {row['launches']}")
    del steps

    # (b) the same builder at minicpm-2b's full width, fp32, 2 slots
    t0 = time.perf_counter()
    geometry = InventoryConfig(arch=AN_ARCH, smoke=not full, device=device)
    with serving_inventory(geometry) as inv:
        cfg = inv.cfg
        steps = [trace(spec) for spec in inv.specs]
        findings = run_rules(steps, inv, budgets, select=["RPJ101", "RPJ103", "RPJ104"])
    rows = _inventory_rows(steps)
    wide = _wide_conversions(steps)
    primary = "decode_step" if "decode_step" in rows else "decode_step_reference"
    embed_rows = 2 * cfg.d_model * 4  # two slots' fp32 embedding rows
    out["full"] = {"arch": cfg.name, "d_model": cfg.d_model, "layers": cfg.n_layers,
                   "vocab": cfg.vocab_size, "steps": rows,
                   "findings": [f.format() for f in findings], "wide_conversions": wide,
                   "decode_max_gather_bytes": rows[primary]["max_gather_bytes"],
                   "embedding_rows_bytes": embed_rows,
                   "seconds": time.perf_counter() - t0}
    emit({"phase": "analysis", "part": "b: torchcheck at full width", "device": device,
          **out["full"]})
    if findings:
        raise AssertionError("analysis (b): RPJ101/103/104 findings at full width:\n" +
                             "\n".join(f.format() for f in findings))
    if on_card and rows["decode_step"]["max_gather_bytes"] != embed_rows:
        raise AssertionError(f"analysis (b): decode_step's largest gather "
                             f"{rows['decode_step']['max_gather_bytes']} B is not the "
                             f"embedding rows' {embed_rows} B")
    del steps, inv
    if on_card:
        torch.cuda.empty_cache()

    # (c) a full-width engine under the sync guard against an unguarded one
    t0 = time.perf_counter()
    cfg = C.get_config(AN_ARCH, smoke=not full, dtype=torch.float32)
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    rng = np.random.default_rng(20)
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,)).astype("int32")
               for n in AN_SERVE_PROMPTS]
    ec = EngineConfig(max_seqs=2, max_len=128, page_size=16)

    def serve(guard):
        eng = Engine(cfg, params, ec, device=device)
        calls = [0]
        if guard:
            eng._decode = guarded(eng._decode, device, calls)
            eng._chunk = guarded(eng._chunk, device, calls)  # the chunk graphs' replays
        for i, p in enumerate(prompts):
            eng.submit(p, AN_SERVE_NEW, rid=i, arrival_step=i)
        reqs = eng.run()
        return [list(r.out_tokens) for r in reqs], calls[0], eng

    plain, _, _ = serve(False)
    got, calls, eng = serve(True)
    out["guard"] = {"arch": cfg.name, "layers": cfg.n_layers, "requests": len(prompts),
                    "prompt_lens": list(AN_SERVE_PROMPTS), "new_tokens": AN_SERVE_NEW,
                    "guarded_calls": calls, "decode_steps": eng.decode_steps,
                    "prefill_chunks": eng.prefill_chunks, "tokens_equal": got == plain,
                    "seconds": time.perf_counter() - t0}
    emit({"phase": "analysis", "part": "c: serving under the sync guard", "device": device,
          **out["guard"]})
    if got != plain or any(len(t) != AN_SERVE_NEW for t in got):
        raise AssertionError(f"analysis (c): guarded tokens differ from unguarded: "
                             f"{got} vs {plain}")
    if calls != eng.decode_steps + eng.prefill_chunks:
        raise AssertionError(f"analysis (c): {calls} guarded calls, "
                             f"{eng.decode_steps} decodes + {eng.prefill_chunks} chunks")
    del params, eng
    if on_card:
        torch.cuda.empty_cache()

    # (d) a 1 x 2 rank's weights, cut from a full tree on the device, each
    # in a storage of its own: a view would keep the full leaf alive and
    # read as the whole leaf's bytes (torchcheck's mesh arguments)
    out["placement"] = _placement_storages(torch, device)
    emit({"phase": "analysis", "part": "d: a 1 x 2 rank's placed weights", "device": device,
          "ranks": out["placement"]})
    for rank, row in out["placement"].items():
        if row["views"] or row["storage_bytes"] != row["bytes"]:
            raise AssertionError(f"analysis (d): rank {rank}'s placed leaves are views of "
                                 f"larger storages: {row}")
    return out


# --------------------------------------------------------------------------
# 21. the decode step as one CUDA graph, at each served family's decode shape
# --------------------------------------------------------------------------

GRAPH_NEW = 16  # new tokens a request
# prompt lengths in pages: just under a page boundary, so a decoding slot
# grows within GRAPH_NEW tokens; the second is the first's prefix, its tail
# page shared (copy-on-write where the family shares pages)
GRAPH_PAGES = (2.97, 1.6, 2.95, 1.95, 2.2)
GRAPH_POOL_PAGES = 6  # 5 usable pages for 4 slots: growth preempts


def graph_models(torch, full: bool = True) -> dict:
    """{label: (fp32 config, the decode kernel a layer, or None)} of the
    served families at their decode shapes: the serving phases' cuts
    (``full=False``: the smoke configs with pages of 8, for the CPU)."""
    import dataclasses

    import repro_torch.configs as C

    dense = dict(n_layers=3, family="dense", n_experts=0, n_shared_experts=0, top_k=0,
                 moe_d_ff=0, first_k_dense=0, mtp_depth=0)
    rows = (("starcoder2-7b 8 layers", "starcoder2-7b", {"n_layers": 8},
             "paged_attention_decode"),
            ("deepseek-v3 dense prefix", "deepseek-v3-671b", dense, "mla_paged_attention_decode"),
            ("granite-moe-3b-a800m 8 layers", "granite-moe-3b-a800m",
             {"n_layers": CUT_DEPTH["granite-moe-3b-a800m"]}, "paged_attention_decode"),
            ("h2o-danube-3-4b 8 layers", "h2o-danube-3-4b",
             {"n_layers": CUT_DEPTH["h2o-danube-3-4b"]}, None),
            ("mamba2-130m", "mamba2-130m", {}, None),
            ("hymba-1.5b 8 layers", "hymba-1.5b", {"n_layers": CUT_DEPTH["hymba-1.5b"]}, None),
            ("whisper-tiny", "whisper-tiny", {}, "paged_attention_decode"))
    out = {}
    for label, arch, over, kernel in rows:
        if not full:
            over = {**{k: v for k, v in over.items() if k != "n_layers"}, "block": 8}
        cfg = dataclasses.replace(C.get_config(arch, smoke=not full, dtype=torch.float32),
                                  **over)
        out[label] = (cfg, kernel)
    return out


def graph_traffic(cfg, page: int):
    """5 prompts of GRAPH_PAGES pages from a numpy seed, arrivals every 2
    engine steps; each request's audio for an enc-dec config."""
    import numpy as np

    from repro_torch.launch.serve import audio_extras

    rng = np.random.default_rng(21)
    lens = [int(page * f) for f in GRAPH_PAGES]
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32) for n in lens]
    prompts[1] = prompts[0][:lens[1]].copy()
    return prompts, [2 * i for i in range(len(prompts))], audio_extras(cfg, len(prompts), 21)


def _paged_pools(cfg) -> set:
    """(segment, adapter key) of the paged pools: page 0 is the null page,
    where inactive slots write in an undefined order."""
    from repro_torch.models import adapters as A

    return {(f"seg{si}", ad.key) for si, (kind, _) in enumerate(A.layer_segments(cfg))
            for ad in A.adapters_for(cfg, kind) if ad.paged}


def graph_checked(torch, eng, device: str) -> dict:
    """Replace ``eng._decode`` (the engine's :class:`DecodeGraph`) by a
    checker: each call runs under the sync guard, then the eager decode step
    runs on a clone of the pool from before the call and a copy of the
    runner's input buffers; the active slots' logits and greedy tokens and
    every pool leaf but the null page must be bit-identical, and every
    buffer, pool leaf and the page-table mirror keep their storage.
    Returns the record the checker fills."""
    from repro_torch import tree as T
    from repro_torch.analysis.torchcheck.harness import sync_guard
    from repro_torch.serve.engine import step_fns

    runner = eng._decode
    step = step_fns(eng.cfg)["decode_step"][0]
    paged = _paged_pools(eng.cfg)
    buffers = (runner.tokens, runner.seq_pos, runner.table, runner.active, runner.greedy,
               runner.logits)
    table = eng.kv.page_table()
    ptrs = ([t.data_ptr() for t in buffers], eng.kv.pool_ptrs(), table.data_ptr())
    rec = {"runner": runner, "replays": 0, "differ": [], "moved": 0}

    def checked(params, pool, tokens, seq_pos, page_table, active):
        before = T.tree_map(lambda t: t.clone(), pool)
        with sync_guard(device):
            greedy, logits, pool = runner(params, pool, tokens, seq_pos, page_table, active)
        with torch.no_grad():
            want_g, want_l, want_pool = step(params, before, runner.tokens.clone(),
                                             runner.seq_pos.clone(), runner.table.clone(),
                                             runner.active.clone())
        on = runner.active
        differ = []
        if not (torch.equal(greedy[on], want_g[on]) and torch.equal(logits[on], want_l[on])):
            differ.append("logits")
        for seg, tree in pool.items():
            for key, leaves in tree.items():
                for name, leaf in leaves.items():
                    want = want_pool[seg][key][name]
                    if (seg, key) in paged:
                        leaf, want = leaf[:, 1:], want[:, 1:]
                    if not torch.equal(leaf, want):
                        differ.append(f"{seg}/{key}/{name}")
        if differ:
            rec["differ"].append({"replay": rec["replays"], "differ": differ})
        now = ([t.data_ptr() for t in buffers], eng.kv.pool_ptrs(),
               eng.kv.page_table().data_ptr())
        rec["moved"] += now != ptrs or eng.kv.page_table() is not table
        rec["replays"] += 1
        return greedy, logits, pool

    eng._decode = checked
    return rec


def graph_summary(eng, rec, label: str, kernel, checks_preemption: bool,
                  on_card: bool) -> dict:
    """One engine's phase-21 line; raises on a failed gate."""
    runner = rec["runner"]
    reqs = [eng.sched.finished[r] for r in sorted(eng.sched.finished)]
    preempted = sum(r.stats.n_preemptions for r in reqs)
    want_launches = {kernel: eng.cfg.n_layers} if kernel and on_card else {}
    row = {"phase": "graph", "model": label, "slots": eng.ec.max_seqs,
           "layers": eng.cfg.n_layers, "requests": len(reqs),
           "decode_steps": eng.decode_steps, "replays_checked": rec["replays"],
           "replays_differing": rec["differ"], "storages_moved": rec["moved"],
           "cow_copies": eng.kv.cow_copies, "preemptions": preempted,
           "captures": runner.captures, "capture_s": runner.capture_seconds,
           "private_pool_bytes": runner.pool_bytes,
           "warmup_launches": runner.warmup_launches,
           "replay_launches": runner.replay_launches}
    emit(row)
    fails = []
    if rec["differ"] or rec["moved"]:
        fails.append("replays differ from the eager step or storages moved")
    if rec["replays"] != eng.decode_steps or runner.calls != eng.decode_steps:
        fails.append("not every decode step went through the checked runner")
    if runner.captures != int(on_card):
        fails.append(f"{runner.captures} captures")
    if runner.replay_launches != want_launches:
        fails.append(f"replay launches {runner.replay_launches}, want {want_launches}")
    if len(reqs) != len(eng.sched.finished) or len(reqs) <= eng.ec.max_seqs:
        fails.append("no slot refill")
    if eng.kv.skip_prefill and eng.kv.cow_copies < 1:  # a shared tail page
        fails.append("no copy-on-write")
    if checks_preemption and preempted < 1:
        fails.append("no preemption")
    if fails:
        raise AssertionError(f"graph {label}: " + "; ".join(fails))
    return row


def _pool_differ(torch, cfg, got, want, skip_null: bool = True) -> list:
    """The pool leaves (the null page cut from paged ones with ``skip_null``)
    that are not bit-identical."""
    paged = _paged_pools(cfg)
    differ = []
    for seg, tree in got.items():
        for key, leaves in tree.items():
            for name, leaf in leaves.items():
                other = want[seg][key][name]
                if skip_null and (seg, key) in paged:
                    leaf, other = leaf[:, 1:], other[:, 1:]
                if not torch.equal(leaf, other):
                    differ.append(f"{seg}/{key}/{name}")
    return differ


def _eager_chunk(torch, eng, runner, pool):
    """The chunk step called eagerly on ``pool`` and copies of the runner's
    input buffers: (logits, pool)."""
    from repro_torch.serve.engine import step_fns

    step = step_fns(eng.cfg)["prefill_chunk"][0]
    with torch.no_grad():
        row = runner.mirror.index_select(0, runner.slot.reshape(1))[0].clone()
        return step(eng.params, pool, runner.tokens.clone(), runner.slot.clone(),
                    runner.q_off.clone(), runner.phys_tok.clone(), runner.off_tok.clone(),
                    row, runner.last_idx.clone())


def chunk_checked(torch, eng, device: str) -> dict:
    """Phase 21 (f): wrap ``eng._chunk`` (which replays the chunk graph of
    the chunk's shape) in a checker: each call runs under the sync guard,
    then the eager chunk step runs on a clone of the pool from before the
    call and copies of the runner's input buffers; the logits and every
    pool leaf but the null page must be bit-identical, and each runner's
    buffers, the pool leaves and the page-table mirror keep their storage.
    Returns the record the checker fills."""
    from repro_torch import tree as T
    from repro_torch.analysis.torchcheck.harness import sync_guard

    real = eng._chunk
    table = eng.kv.page_table()
    pool_ptrs = eng.kv.pool_ptrs()
    rec = {"replays": 0, "differ": [], "moved": 0, "order": [], "ptrs": {}}

    def checked(params, pool, toks, slot, off, phys, offs, last):
        before = T.tree_map(lambda t: t.clone(), pool)
        with sync_guard(device):
            logits, pool = real(params, pool, toks, slot, off, phys, offs, last)
        n = toks.shape[1]
        runner = eng._chunk_graphs[n]
        want_l, want_pool = _eager_chunk(torch, eng, runner, before)
        differ = ([] if torch.equal(logits, want_l) else ["logits"]) + _pool_differ(
            torch, eng.cfg, pool, want_pool)
        if differ:
            rec["differ"].append({"replay": rec["replays"], "shape": n, "differ": differ})
        ptrs = [t.data_ptr() for t in (runner.tokens, runner.phys_tok, runner.off_tok,
                                       runner.scalars)]
        rec["moved"] += (rec["ptrs"].setdefault(n, ptrs) != ptrs
                         or eng.kv.pool_ptrs() != pool_ptrs or eng.kv.page_table() is not table)
        rec["order"].append(n)
        rec["replays"] += 1
        return logits, pool

    eng._chunk = checked
    return rec


def chunk_swapped(torch, eng, device: str) -> dict:
    """Phase 21 (f), after the engine drained: each chunk runner replayed
    once more in the reverse of its capture order, slot 0 on a first chunk
    of fresh tokens, its K/V on the null page at distinct offsets; each
    replay (under the sync guard) against the eager step on a clone of the
    pool from before it, every pool leaf bit-identical (the null page
    included)."""
    import numpy as np

    from repro_torch import tree as T
    from repro_torch.analysis.torchcheck.harness import sync_guard

    order = list(eng._chunk_graphs)  # insertion order: the capture order
    rng = np.random.default_rng(31)
    differ = []
    for n in reversed(order):
        runner = eng._chunk_graphs[n]
        toks = rng.integers(0, eng.cfg.vocab_size, size=(1, n)).astype(np.int32)
        zeros, offs = np.zeros(n, np.int32), (np.arange(n) % eng.kv.page_size).astype(np.int32)
        before = T.tree_map(lambda t: t.clone(), eng.kv.data)
        eng.kv.page_table()
        with sync_guard(device):
            logits, _ = runner(eng.params, eng.kv.data, toks, 0, 0, zeros, offs, n - 1)
        want_l, want_pool = _eager_chunk(torch, eng, runner, before)
        bad = ([] if torch.equal(logits, want_l) else ["logits"]) + _pool_differ(
            torch, eng.cfg, eng.kv.data, want_pool, skip_null=False)
        if bad:
            differ.append({"shape": n, "differ": bad})
    return {"order": list(reversed(order)), "differ": differ}


def chunk_summary(eng, rec, swapped, label: str, on_card: bool) -> dict:
    """One engine's phase-21 (f) line; raises on a failed gate."""
    from repro_torch.serve.engine import chunk_shape_set

    runners = eng._chunk_graphs
    allowed = set(chunk_shape_set(eng.cfg, eng.chunk_size))
    row = {"phase": "graph", "part": "f: chunk graphs", "model": label,
           "slots": eng.ec.max_seqs, "chunks": eng.prefill_chunks,
           "replays_checked": rec["replays"], "replays_differing": rec["differ"],
           "storages_moved": rec["moved"], "shapes": list(runners),
           "shape_order": rec["order"], "captures": {n: r.captures for n, r in runners.items()},
           "capture_s": {n: r.capture_seconds for n, r in runners.items()},
           "pool_bytes": {n: r.pool_bytes for n, r in runners.items()},
           "replay_launches": {n: r.replay_launches for n, r in runners.items()},
           "swapped_order": swapped["order"], "swapped_differing": swapped["differ"]}
    emit(row)
    fails = []
    if rec["differ"] or rec["moved"] or swapped["differ"]:
        fails.append("replays differ from the eager chunk or storages moved")
    if rec["replays"] != eng.prefill_chunks or sum(r.calls for r in runners.values()) != (
            eng.prefill_chunks + len(runners)):
        fails.append("not every chunk went through the checked runners")
    if set(runners) != set(rec["order"]) or not set(runners) <= allowed:
        fails.append(f"shapes {sorted(runners)} not the chunks' or outside chunk_shape_set")
    if any(r.captures != int(on_card) for r in runners.values()):
        fails.append("not one capture a shape")
    if fails:
        raise AssertionError(f"graph (f) {label}: " + "; ".join(fails))
    return row


def server_graph_models(torch, full: bool = True) -> dict:
    """{label: fp32 config} of phase 21 (g): starcoder2-7b cut to 8 layers
    and qwen2-vl-72b cut to 4, at full width (``full=False``: the smoke
    configs with blocks of 8, for the CPU)."""
    import dataclasses

    import repro_torch.configs as C

    rows = (("starcoder2-7b 8 layers", "starcoder2-7b", 8),
            ("qwen2-vl-72b 4 layers", "qwen2-vl-72b", 4))
    out = {}
    for label, arch, layers in rows:
        cfg = C.get_config(arch, smoke=not full, dtype=torch.float32)
        out[label] = dataclasses.replace(cfg, **({"n_layers": layers} if full else
                                                 {"block": 8}))
    return out


def server_waves(cfg, full: bool):
    """Phase 21 (g)'s three waves, each a list of (prompt, extras): 2
    requests, then 1, then the first wave's 2 again.  A vision config takes
    :func:`vision_traffic`'s requests; starcoder2-7b two 300-token prompts and
    one of 200 (smoke: 12 and 9)."""
    import numpy as np

    if cfg.frontend == "vision":
        prompts, extras = vision_traffic(cfg)
        reqs = list(zip(prompts, extras))
    else:
        rng = np.random.default_rng(41)
        lens = (300, 300, 200) if full else (12, 12, 9)
        reqs = [(rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32), None)
                for n in lens]
    return [reqs[:2], reqs[2:3], reqs[:2]]


def server_graph_part(torch, device: str = "cuda", full: bool = True) -> dict:
    """Phase 21 (g): the static ``Server``'s graphs, fp32, for starcoder2-7b
    (8 layers) and qwen2-vl-72b (4 layers): three waves of 2, 1 and 2
    requests (the 2-request graphs replayed after the 1-request ones were
    captured), 8 new tokens.  Each prefill and decode call runs under the
    sync guard, then the eager step on the same inputs (the decode on a
    clone of the caches before the call, the position a device scalar as
    the graph's); logits and every cache leaf bit-identical (the
    prefill's caches against the first slots of the wave's tree, which the
    graph writes); one prefill capture a prompt shape and one decode capture a batch size; each
    batch size's tree keeps its storages; the third wave's tokens equal
    the first's."""
    import numpy as np

    from repro_torch import tree as T
    from repro_torch.analysis.torchcheck.harness import sync_guard
    from repro_torch.models import model as M
    from repro_torch.serve import ServeConfig, Server

    on_card = torch.device(device).type == "cuda"
    max_new = 8
    out = {}
    for label, cfg in server_graph_models(torch, full).items():
        t0 = time.perf_counter()
        params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                               device=device)
        waves = server_waves(cfg, full)
        S_max = max(len(p) for wave in waves for p, _ in wave)
        srv = Server(cfg, params, ServeConfig(max_len=S_max + max_new), device=device)
        rec = {"prefills": 0, "decodes": 0, "differ": [], "shapes": []}
        real_prefill, real_decode = srv._prefill, srv._decode

        def prefill(params, batch, caches, last_idx=None):
            with sync_guard(device):
                logits = real_prefill(params, batch, caches, last_idx)
            li = None if last_idx is None else torch.tensor(last_idx, dtype=torch.int32,
                                                             device=device)
            with torch.no_grad():
                want_l, want_c = M.prefill(cfg, params, batch, li)
            slots = [(caches[seg][key][name], leaf) for seg, tree in want_c.items()
                     for key, leaves in tree.items() for name, leaf in leaves.items()]
            bad = ([] if torch.equal(logits, want_l) else ["logits"]) + [
                "caches" for a, b in slots
                if not torch.equal(a[tuple(slice(0, n) for n in b.shape)], b.to(a.dtype))][:1]
            if bad:
                rec["differ"].append({"prefill": rec["prefills"], "differ": bad})
            rec["prefills"] += 1
            rec["shapes"].append(tuple(batch["tokens"].shape))
            return logits

        def decode(params, caches, tokens, pos):
            before = T.tree_map(lambda t: t.clone(), caches)
            with sync_guard(device):
                logits, caches = real_decode(params, caches, tokens, pos)
            with torch.no_grad():
                want_l, want_c = M.decode_step(
                    cfg, params, before, tokens.clone(),
                    torch.tensor(pos, dtype=torch.int32, device=device))
            bad = ([] if torch.equal(logits, want_l) else ["logits"]) + [
                "caches" for a, b in zip(T.leaves(caches), T.leaves(want_c))
                if not torch.equal(a, b)][:1]
            if bad:
                rec["differ"].append({"decode": rec["decodes"], "pos": pos, "differ": bad})
            rec["decodes"] += 1
            return logits, caches

        srv._prefill, srv._decode = prefill, decode
        tokens, ptrs = [], {}
        for wave in waves:
            batch = {"tokens": np.stack([p for p, _ in wave])}
            if wave[0][1]:
                batch.update({k: np.concatenate([x[k] for _, x in wave], axis=1 if
                                                k == "positions3" else 0)
                              for k in wave[0][1]})
            tokens.append(srv.generate(batch, max_new))
            B = len(wave)
            now = [t.data_ptr() for t in T.leaves(srv._caches[B])]
            rec.setdefault("moved", 0)
            rec["moved"] += ptrs.setdefault(B, now) != now
        pre = srv._prefill_graphs
        dec = srv._decode_graphs
        row = {"phase": "graph", "part": "g: Server graphs", "model": label,
               "layers": cfg.n_layers, "waves": [len(w) for w in waves],
               "prompt_shapes": rec["shapes"], "prefills_checked": rec["prefills"],
               "decodes_checked": rec["decodes"], "differing": rec["differ"],
               "storages_moved": rec["moved"],
               "prefill_captures": [g.captures for g in pre.values()],
               "decode_captures": {b: g.captures for b, g in dec.items()},
               "capture_s": [g.capture_seconds for g in (*pre.values(), *dec.values())],
               "pool_bytes": [g.pool_bytes for g in (*pre.values(), *dec.values())],
               "tokens_wave3_equal_wave1": bool(np.array_equal(tokens[2], tokens[0])),
               "seconds": time.perf_counter() - t0}
        emit(row)
        fails = []
        if rec["differ"] or rec["moved"]:
            fails.append("replays differ from the eager steps or storages moved")
        if len(pre) != len(set(rec["shapes"])) or any(
                g.captures != int(on_card) for g in (*pre.values(), *dec.values())):
            fails.append("not one capture a shape")
        if set(dec) != {1, 2} or rec["decodes"] != 3 * max_new:
            fails.append("not every decode step went through the runners")
        if not row["tokens_wave3_equal_wave1"]:
            fails.append("the third wave's tokens differ from the first's")
        if fails:
            raise AssertionError(f"graph (g) {label}: " + "; ".join(fails))
        out[label] = row
        del params, srv, real_prefill, real_decode
        if on_card:
            torch.cuda.empty_cache()
    return out


def graph_sync_child(kind: str = "decode") -> None:
    """Phase 21 (d), in a process of its own (a failed capture may leave the
    capture stream current): the decode step (``kind="chunk"``: the chunk
    step, phase 21 (f)) of starcoder2-7b at full width, 2 layers, with a
    ``.item()`` injected after it.  The runner must raise at the capture,
    after its warm-up calls and before any other call.  Prints one JSON
    line."""
    import dataclasses

    sys.path.insert(0, str(SRC))
    import torch

    import repro_torch.configs as C
    from repro_torch.models import model as M
    from repro_torch.serve.engine import step_fns
    from repro_torch.serve.graphs import WARMUP_STEPS, ChunkGraph, DecodeGraph

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(C.get_config("starcoder2-7b", dtype=torch.float32), n_layers=2)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    pool = M.init_paged_cache(cfg, 4, GRAPH_POOL_PAGES, 128, 512, device="cuda")
    step = step_fns(cfg)["decode_step" if kind == "decode" else "prefill_chunk"][0]
    calls = [0]

    def with_sync(*args):
        calls[0] += 1
        out = step(*args)
        if args[3].sum().item() < 0:  # a host sync inside the step
            raise AssertionError("unreachable")
        return out

    mirror = torch.zeros((4, 4), dtype=torch.int32, device="cuda")  # the page table
    error = None
    try:
        if kind == "decode":
            DecodeGraph(with_sync, params, pool, 4, 4, "cuda", table=mirror)
        else:
            import numpy as np

            runner = ChunkGraph(with_sync, params, pool, mirror, 128, "cuda")
            runner(params, pool, np.zeros((1, 128), np.int32), 0, 0,
                   np.zeros(128, np.int32), np.arange(128, dtype=np.int32), 127)
    except RuntimeError as e:  # the capture refuses the sync
        error = f"{type(e).__name__}: {e}"[:300]
    print(json.dumps({"raised": error is not None, "error": error,
                      "step_calls": calls[0], "warmup_steps": WARMUP_STEPS}), flush=True)


def graph_phase(torch, kernels, device: str = "cuda", full: bool = True) -> dict:
    """The engine's decode step as one CUDA graph (``serve/graphs.py``), in
    fp32 at each served family's decode shape: each engine serves
    ``graph_traffic`` on a small pool (admission, copy-on-write where the
    family shares pages, preemption, slot refill) through
    :func:`graph_checked`; (a) every replay bit-identical to the eager step,
    (b) one capture an engine, no storage moved, (c) no sync inside a
    replay, (e) each capture's seconds and private-pool bytes printed.
    starcoder2-7b runs two engines, 2 then 4 slots, stepped in turns: the
    first one's captured workspaces outlive the second's larger ones.  (d)
    A step with an injected ``.item()`` makes the capture raise (in a
    process of its own).  ``device="cpu", full=False`` rehearses the phase
    on the CPU (the runner calls the step eagerly there: no capture)."""
    from repro_torch.models import model as M

    on_card = torch.device(device).type == "cuda"
    page = 128 if full else 8
    gen = torch.Generator(device=device).manual_seed(0)
    out = {}
    for i, (label, (cfg, kernel)) in enumerate(graph_models(torch, full).items()):
        t0 = time.perf_counter()
        params = M.init_params(cfg, gen, device=device)
        prompts, arrivals, extras = graph_traffic(cfg, page)
        context = cfg.max_decoder_positions if cfg.n_encoder_layers else 64 * page
        ec = dict(max_len=min(5 * page, context), page_size=page, prefill_chunk=0,
                  num_pages=GRAPH_POOL_PAGES)
        engines = [run_engine(cfg, params, prompts, arrivals, GRAPH_NEW, device=device,
                              extras=extras, max_seqs=slots, **ec)
                   for slots in ((2, 4) if i == 0 else (4,))]
        recs = [graph_checked(torch, eng, device) for eng in engines]
        chunk_recs = [chunk_checked(torch, eng, device) for eng in engines]
        while any(eng.sched.has_work() for eng in engines):
            for eng in engines:
                if eng.sched.has_work():
                    eng.step()
        for eng in engines:
            eng._flush_pending()
        rows = [graph_summary(eng, rec, label, kernel, eng.ec.max_seqs == 4, on_card)
                for eng, rec in zip(engines, recs)]
        chunk_rows = [chunk_summary(eng, rec, chunk_swapped(torch, eng, device), label,
                                    on_card) for eng, rec in zip(engines, chunk_recs)]
        out[label] = {"rows": rows, "chunk_rows": chunk_rows,
                      "seconds": time.perf_counter() - t0}
        del params, engines, recs
        if on_card:
            torch.cuda.empty_cache()
    out["server"] = server_graph_part(torch, device, full)
    if on_card:
        for kind, part in (("decode", "d"), ("chunk", "f")):
            child = subprocess.run(
                [sys.executable, "-c",
                 f"import chip_smoke; chip_smoke.graph_sync_child({kind!r})"],
                cwd=ROOT, capture_output=True, text=True, timeout=600)
            lines = child.stdout.strip().splitlines()
            got = json.loads(lines[-1]) if child.returncode == 0 and lines else None
            emit({"phase": "graph", "part": f"{part}: a sync injected into the {kind} step",
                  "exit": child.returncode, **(got or {"stderr": child.stderr[-2000:]})})
            if not got or not got["raised"] or got["step_calls"] != got["warmup_steps"] + 1:
                raise AssertionError(f"graph ({part}): the injected sync did not make the "
                                     f"capture raise right after the warm-up: {got}")
            out[f"sync_child_{kind}"] = got
    return out


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
    t0 = time.perf_counter()

    def done(phase: str) -> None:  # each phase's seconds, on a line of its own
        nonlocal t0
        emit({"phase": phase, "seconds": time.perf_counter() - t0})
        t0 = time.perf_counter()

    # 3. kernels against their plain versions
    summary = kernel_phase(torch, gen)
    attention_phase(torch, gen)
    layernorm_phase(torch, gen)
    emit({"phase": "kernels", "names": list(LAUNCHES_PER_FORWARD),
          "launches_during_checks": kernels.launch_counts()})
    done("kernels")

    # 4. the encoder path end to end
    counted = encoder_phase(torch, gen, kernels)
    done("encoder")

    # 5. the serving kernels against their plain versions
    serving = serving_kernel_phase(torch, gen)
    bf16_dense_check(torch, gen, kernels)
    emit({"phase": "serving_kernels", "names": list(SERVING_KERNELS),
          "launches_during_checks": kernels.launch_counts()})
    done("serving_kernels")

    # 6. the serving path end to end
    served = serve_phase(torch, kernels)
    counted.update(paged_attention_decode=served["launches"]["paged_attention_decode"],
                   paged_copy=served["launches"]["paged_copy"],
                   rwma_gemm=served["rwma_launches"])
    done("serve")

    # 7. the MLA decode, softmax and transpose kernels, and the blocked-ops path
    mla = mla_kernel_phase(torch, gen)
    emit({"phase": "mla_kernels", "names": list(MLA_KERNELS),
          "launches_during_checks": kernels.launch_counts()})
    blocked = blocked_ops_path(torch, gen, kernels)
    counted.update(bwma_softmax=blocked["bwma_softmax"],
                   bwma_transpose=blocked["bwma_transpose"])
    done("mla_kernels")

    # 8. MLA serving end to end
    mla_counts = mla_serve_phase(torch, kernels)
    counted["mla_paged_attention_decode"] = mla_counts["mla_paged_attention_decode"]
    serving.update(mla)
    done("mla_serve")

    # 9. MoE serving end to end: granite-moe-3b-a800m, DeepSeek-V3's MoE layer
    moe = moe_serve_phase(torch, kernels)
    done("moe_serve")

    # 10. the sliding-window ring end to end: h2o-danube-3-4b
    swa = swa_serve_phase(torch, kernels)
    done("swa_serve")

    # 11. SSM state rows end to end: mamba2-130m, hymba-1.5b
    ssm_serve_phase(torch, kernels)
    done("ssm_serve")

    # 12. enc-dec end to end: whisper-tiny with per-request audio
    encdec, whisper_errs = encdec_serve_phase(torch, kernels)
    done("encdec_serve")

    # 13. the vision frontend: qwen2-vl-72b's image prefix and M-RoPE
    vision_serve_phase(torch, kernels)
    done("vision_serve")

    # 14. training: minicpm-2b, the card against the CPU, then full depth
    train_phase(torch, kernels)
    done("train")

    # 15. tensor-parallel serving: two ranks on a 1 x 2 mesh
    tp, tp_checked = tp_serve_phase(torch, kernels)
    done("tp_serve")

    # 16. training on a data x model mesh: two ranks, 2 x 1 and 1 x 2
    tp_train_phase(torch, kernels)
    done("tp_train")
    tp_rank0 = {name: run["launches_per_rank"][0] for name, run in tp.items()}

    # 17. serving on a data x model mesh: four ranks on 2 x 2, drawn by shards
    dp = dp_serve_phase(torch, kernels, checked=tp_checked)
    done("dp_serve")
    dp_rank0 = {name: run["launches_per_rank"][0] for name, run in dp.items()}

    # 18. the paper's memory model on the card
    memmodel_phase(torch)
    done("memmodel")

    # 19. the dry run on one device against a real run
    dryrun_phase(torch)
    done("dryrun")

    # 20. the analysis tools: torchcheck's inventory, the sync guard
    analysis_phase(torch)
    done("analysis")

    # 21. the decode step as one CUDA graph, each served family
    graph_phase(torch, kernels)
    done("graph")

    # the decode kernels' launches in each serving run that drives them
    by_run = {
        "paged_attention_decode": {
            "starcoder2-7b fp32": served["launches"]["paged_attention_decode"],
            "granite-moe-3b-a800m fp32": moe["granite"]["paged_attention_decode"],
            "h2o-danube-3-4b fp32": swa["paged_attention_decode"],
            "whisper-tiny fp32": encdec["paged_attention_decode"],
            "starcoder2-7b 8 layers fp32, rank 0 of 1 x 2":
                tp_rank0["starcoder2-7b"]["paged_attention_decode"],
            "granite-moe-3b-a800m fp32, rank 0 of 1 x 2":
                tp_rank0["granite-moe-3b-a800m"]["paged_attention_decode"],
            "starcoder2-7b 8 layers fp32, rank 0 of 2 x 2":
                dp_rank0["starcoder2-7b"]["paged_attention_decode"],
            "granite-moe-3b-a800m fp32, rank 0 of 2 x 2":
                dp_rank0["granite-moe-3b-a800m"]["paged_attention_decode"]},
        "paged_copy": {
            "starcoder2-7b fp32": served["launches"]["paged_copy"],
            "deepseek-v3 dense prefix fp32": mla_counts["paged_copy"],
            "granite-moe-3b-a800m fp32": moe["granite"]["paged_copy"],
            "whisper-tiny fp32": encdec["paged_copy"],
            "starcoder2-7b 8 layers fp32, rank 0 of 1 x 2": tp_rank0["starcoder2-7b"]["paged_copy"],
            "deepseek-v3 dense prefix fp32, rank 0 of 1 x 2":
                tp_rank0["deepseek-v3 dense prefix"]["paged_copy"],
            "starcoder2-7b 8 layers fp32, rank 0 of 2 x 2": dp_rank0["starcoder2-7b"]["paged_copy"],
            "deepseek-v3 dense prefix fp32, rank 0 of 2 x 2":
                dp_rank0["deepseek-v3 dense prefix"]["paged_copy"]},
        "mla_paged_attention_decode": {
            "deepseek-v3 dense prefix fp32": mla_counts["mla_paged_attention_decode"],
            "deepseek-v3 4 layers (moe) bf16": moe["deepseek"]["mla_paged_attention_decode"],
            "deepseek-v3 dense prefix fp32, rank 0 of 1 x 2":
                tp_rank0["deepseek-v3 dense prefix"]["mla_paged_attention_decode"],
            "deepseek-v3 dense prefix fp32, rank 0 of 2 x 2":
                dp_rank0["deepseek-v3 dense prefix"]["mla_paged_attention_decode"]},
    }

    # the decode kernel's checks at the other serving runs' decode shapes
    checked_at = {"paged_attention_decode": {
        f"granite-moe-3b-a800m {list(GRANITE_DECODE)}": moe["granite_decode_errs"],
        f"whisper-tiny {list(WHISPER_DECODE)}": whisper_errs, **tp_checked}}

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
            "device_ms": per["device_ms"], "device_ms_from": per["device_ms_from"],
            "host_us": per["host_us"], "library_device_ms": per["library_device_ms"],
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
            "device_ms_from": row["device_ms_from"], "host_us": row["host_us"],
            "library_device_ms": row["library_device_ms"], "work": row["work"],
        })
        if kernel in by_run:
            line[-1]["launches_by_run"] = by_run[kernel]
        if kernel in checked_at:
            line[-1]["max_abs_err_at"] = checked_at[kernel]
            line[-1]["max_abs_err"] = max(row["max_abs_err"], *(
                e["float32"] for e in checked_at[kernel].values()))
        if not all(math.isfinite(row[k]) for k in ("ms", "plain_ms", "bound_ms")):
            raise AssertionError(f"{kernel}: timing not finite")
    emit({"phase": "profiler", **PROFILER_MISSES})
    emit({"kernels": line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
