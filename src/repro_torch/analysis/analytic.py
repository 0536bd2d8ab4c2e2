# repro: noqa-file RPR004 -- the paper's analytic cost model is inherently
# per-family math; it never executes layers, so the registry rule is moot
"""Analytic roofline term calculator.

Counterpart of ``repro.analysis.analytic``: the same model math, with the
constants of an NVIDIA H100 SXM (80 GB HBM3) in place of the TPU's.

Why analytic: the dry run (:mod:`repro_torch.launch.dryrun`) records the
per-device FLOPs, collectives and memory of one step of rank 0's program on
the meta device; the roofline terms come from the model math below, which we
can state exactly because we wrote the model.

All quantities are PER DEVICE PER STEP unless suffixed ``_global``.

Constants (all "spec", from NVIDIA's H100 SXM data sheet): 989e12 dense bf16
FLOP/s, 3.35e12 B/s of HBM3.  The link term: a 16-wide model axis spans two
8-GPU NVLink nodes, so a collective over it crosses the slowest link between
them, 400 Gb/s NDR InfiniBand, 50e9 B/s per GPU; NVLink (450e9 B/s a
direction) inside a node is faster and not the bound.

Sharding assumptions (must match distributed/sharding.py):
  * weights stored ZeRO-sharded over all ``n_dev`` devices; TP shard is
    ``1/tp`` of each tensor, the dp extension holds storage only;
  * compute-time weights are gathered over dp → each device streams the
    full ``1/tp`` TP shard per use (fwd, remat-fwd, bwd);
  * batch over dp; TP activations all-reduced twice per layer (Megatron),
    twice more in backward;
  * MoE dispatch/combine are all-to-alls of the routed token embeddings;
  * decode reads the whole cache shard + the full (1/tp) weight shard per
    token; FSDP weight gathers cross the network every step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import SHAPES, ModelConfig
from repro_torch.distributed.sharding import REPLICATE_BELOW

PEAK_FLOPS = 989e12  # spec: H100 SXM dense bf16 FLOP/s
HBM_BW = 3.35e12  # spec: H100 SXM HBM3 bytes/s
LINK_BW = 50e9  # spec: 400 Gb/s NDR InfiniBand per GPU, the slowest link of a
                # 16-wide model axis over two 8-GPU NVLink nodes

BYTES_P = 2  # bf16 params/activations


@dataclasses.dataclass(frozen=True)
class MeshInfo:
    n_dev: int
    dp: int
    tp: int

    @staticmethod
    def single():
        return MeshInfo(256, 16, 16)

    @staticmethod
    def multi():
        return MeshInfo(512, 32, 16)


def _emb_params(cfg: ModelConfig) -> int:
    return cfg.padded_vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)


def _attn_ctx(cfg: ModelConfig, S: int) -> int:
    """Effective attended context length per query token (avg)."""
    if cfg.family == "ssm":
        return 0
    ctx = S // 2  # causal average
    if cfg.attn_type == "swa":
        ctx = min(ctx, cfg.window)
    return ctx


def step_flops_global(cfg: ModelConfig, shape_name: str) -> float:
    """Exact-ish FLOPs for one step (matmuls only; elementwise ~1%)."""
    shape = SHAPES[shape_name]
    B = shape.global_batch
    if shape.kind == "decode":
        tokens, S_ctx = B, shape.seq_len  # one new token, full cache context
    else:
        tokens, S_ctx = B * shape.seq_len, _attn_ctx(cfg, shape.seq_len)
    n_mat = cfg.active_param_count() - _emb_params(cfg)
    per_tok = 2 * n_mat
    # attention score+value matmuls: 2*2*H*dh*ctx per token per layer
    if cfg.family != "ssm":
        H, dh = cfg.n_heads, (cfg.v_head_dim or cfg.d_head)
        qk_dim = cfg.qk_head_dim
        n_attn_layers = cfg.n_layers
        per_tok += 2 * H * (qk_dim + dh) * S_ctx * n_attn_layers
    if cfg.family in ("ssm", "hybrid"):
        # SSD: intra-chunk quadratic + state updates ~ 2*Q*d_inner + state
        Q = cfg.ssm_chunk
        per_tok += cfg.n_layers * (
            2 * Q * cfg.d_inner + 4 * cfg.d_inner * cfg.ssm_state
        )
    # logits head (train computes all positions; prefill/decode only new)
    logit_toks = tokens if shape.kind == "train" else B
    logits = 2 * cfg.d_model * cfg.padded_vocab * logit_toks
    mult = 3 if shape.kind == "train" else 1  # fwd+bwd
    return mult * (per_tok * tokens + logits) * 1.0


def cache_bytes_global(cfg: ModelConfig, shape_name: str) -> float:
    shape = SHAPES[shape_name]
    if shape.kind != "decode":
        return 0.0
    B, S = shape.global_batch, shape.seq_len
    if cfg.attn_type == "mla":
        per_tok = cfg.kv_lora_rank + cfg.qk_rope_dim
        slots = S
    elif cfg.family == "ssm":
        st = cfg.ssm_nheads * cfg.ssm_headdim * cfg.ssm_state * 4
        return cfg.n_layers * B * st
    elif cfg.attn_type == "swa":
        per_tok = 2 * cfg.n_kv_heads * cfg.d_head
        slots = min(S, cfg.window)
    else:
        per_tok = 2 * cfg.n_kv_heads * cfg.d_head
        slots = S
    total = cfg.n_layers * B * slots * per_tok * BYTES_P
    if cfg.family == "hybrid":
        st = cfg.ssm_nheads * cfg.ssm_headdim * cfg.ssm_state * 4
        total += cfg.n_layers * B * st
    return total


def hbm_bytes_per_device(cfg: ModelConfig, shape_name: str, mesh: MeshInfo,
                         accum: int = 1) -> float:
    shape = SHAPES[shape_name]
    N = cfg.param_count()
    w_stream = N * BYTES_P / mesh.tp  # full TP shard streamed per use
    if shape.kind == "decode":
        # serve mode: 2-D TP over ALL axes, weights resident
        w_stream = N * BYTES_P / mesh.n_dev
    elif N < REPLICATE_BELOW:
        w_stream = N * BYTES_P  # replicated small model
    if shape.kind == "train":
        toks_dev = shape.global_batch * shape.seq_len // mesh.n_dev
        w = 3 * accum * w_stream  # fwd + remat-fwd + bwd
        opt = 16 * N / mesh.n_dev  # p/m/v read+write, fp32 math
        act = 12 * toks_dev * cfg.d_model * BYTES_P * cfg.n_layers
        logits = 4 * toks_dev * cfg.padded_vocab * BYTES_P
        return w + opt + act + logits
    if shape.kind == "prefill":
        toks_dev = shape.global_batch * shape.seq_len // mesh.n_dev
        act = 8 * toks_dev * cfg.d_model * BYTES_P * cfg.n_layers
        return w_stream + act
    # decode
    cache = 2 * cache_bytes_global(cfg, shape_name) / mesh.n_dev
    return w_stream + cache


def collective_bytes_per_device(cfg: ModelConfig, shape_name: str,
                                mesh: MeshInfo, accum: int = 1) -> float:
    """TP all-reduces + FSDP gathers/reduce-scatters + MoE all-to-alls."""
    shape = SHAPES[shape_name]
    N = cfg.param_count()
    fsdp_gather = N * BYTES_P / mesh.tp * (mesh.dp - 1) / mesh.dp
    if N < REPLICATE_BELOW and shape.kind == "train":
        # replicated small model: no gathers, only the f32 grad all-reduce
        toks_dev_mb = (shape.global_batch * shape.seq_len
                       // mesh.n_dev // max(accum, 1))
        return N * 4 * 2 * (mesh.n_dev - 1) / mesh.n_dev
    if shape.kind == "train":
        toks_dev_mb = (shape.global_batch * shape.seq_len
                       // mesh.n_dev // max(accum, 1))
        tp_ar = (4 * cfg.n_layers * toks_dev_mb * cfg.d_model * BYTES_P
                 * 2 * (mesh.tp - 1) / mesh.tp) * accum
        grads_rs = N * 4 / mesh.tp * (mesh.dp - 1) / mesh.dp
        gathers = 2 * accum * fsdp_gather  # fwd+bwd weight gathers / microbatch
        moe = 0.0
        if cfg.n_experts:
            moe = (4 * 2 * shape.global_batch * shape.seq_len // mesh.n_dev
                   * cfg.top_k * cfg.d_model * BYTES_P) * accum / accum
        return tp_ar + grads_rs + gathers + moe
    if shape.kind == "decode":
        # serve mode: weights resident (no gathers); TP all-reduce over all
        # axes of the (tokens, d) activations per layer
        toks = shape.global_batch
        tp_ar = 2 * cfg.n_layers * toks * cfg.d_model * BYTES_P * (
            (mesh.n_dev - 1) / mesh.n_dev)
        moe = (2 * 2 * toks * cfg.top_k * cfg.d_model * BYTES_P
               if cfg.n_experts else 0.0)
        return tp_ar + moe
    toks_dev = max(1, shape.global_batch * shape.seq_len // mesh.n_dev)
    tp_ar = 2 * cfg.n_layers * toks_dev * cfg.d_model * BYTES_P * (
        (mesh.tp - 1) / mesh.tp)
    moe = 0.0
    if cfg.n_experts:
        moe = 2 * 2 * toks_dev * cfg.top_k * cfg.d_model * BYTES_P
    return fsdp_gather + tp_ar + moe


def roofline_terms(cfg: ModelConfig, shape_name: str, mesh: MeshInfo,
                   accum: int = 1) -> Dict[str, float]:
    f_g = step_flops_global(cfg, shape_name)
    t_compute = f_g / (mesh.n_dev * PEAK_FLOPS)
    t_memory = hbm_bytes_per_device(cfg, shape_name, mesh, accum) / HBM_BW
    t_coll = collective_bytes_per_device(cfg, shape_name, mesh, accum) / LINK_BW
    terms = {
        "compute": t_compute, "memory": t_memory, "collective": t_coll,
    }
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    total = sum(terms.values())
    return {
        **terms,
        "dominant": dominant,
        "flops_global": f_g,
        # overlapped bound: step >= max(terms); serial bound: sum(terms).
        "roofline_fraction": t_compute / bound if bound else float("nan"),
        "roofline_fraction_serial": t_compute / total if total else float("nan"),
    }
