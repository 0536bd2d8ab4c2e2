# repro: noqa-file RPR004 -- the family field is *defined* and validated
# here; everything downstream of configs must go through the registry
"""Unified model configuration for every assigned architecture family.

Counterpart of ``repro.configs.base``: the same fields and defaults, with
``dtype`` a torch dtype (``torch.bfloat16`` by default) and
``decode_backend`` naming a backend of this package (``"reference"`` or
``"cuda"``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int

    # attention flavor
    attn_type: str = "full"  # full | swa | mla
    window: int = 4096  # SWA window (attn_type == "swa")
    rope_theta: float = 1e6
    mrope_sections: Tuple[int, ...] = ()  # qwen2-vl M-RoPE (t, h, w) half-dims
    qkv_bias: bool = False
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "silu"  # silu | gelu
    tie_embeddings: bool = False
    use_rope: bool = True

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0  # deepseek-v3: first 3 layers are dense
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # MLA (deepseek-v3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # SSM (mamba2 / hymba)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_chunk: int = 128

    # hybrid (hymba): parallel attention + SSM heads per layer
    hybrid: bool = False

    # multi-token prediction (deepseek-v3)
    mtp_depth: int = 0

    # encoder-decoder (whisper)
    n_encoder_layers: int = 0
    encoder_seq: int = 1500  # whisper: 30 s of audio at 50 Hz after conv stub
    max_decoder_positions: int = 4096  # learned decoder pos-emb table size

    # modality frontend stub: "none" | "vision" | "audio"
    frontend: str = "none"
    n_frontend_tokens: int = 0  # vis/audio embedding positions per sample

    dtype: Any = torch.bfloat16

    # attention q-chunking for memory (flash-style; plain PyTorch)
    q_chunk: int = 512

    # data-layout policy for linear layers (the paper's technique):
    # "xla" is a plain ``x @ w`` (the JAX package leaves it to XLA);
    # "bwma"/"rwma" route matmuls through the blocked / row-major CUDA GEMM
    # kernels (fp32 or bf16, summed in fp32; small scale).
    gemm_backend: str = "xla"
    block: int = 128  # accelerator block (BWMA quantum) when using kernels

    # serving-engine paged-decode execution path (resolve_backend name):
    # "cuda" streams pages through the paged-attention / paged-copy CUDA
    # kernels (their plain versions for CPU tensors); "reference" reads
    # pages through the gather->attend oracle and copies pages by slicing.
    decode_backend: str = "cuda"

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256, as in the JAX package (whose
        tensor-parallel shards need it); the pad columns are masked."""
        return -(-self.vocab_size // 256) * 256

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid / sliding-window)."""
        return self.family in ("ssm", "hybrid") or self.attn_type == "swa"

    @property
    def qk_head_dim(self) -> int:
        if self.attn_type == "mla":
            return self.qk_nope_dim + self.qk_rope_dim
        return self.d_head

    def param_count(self) -> int:
        """Approximate total parameters (for 6ND roofline math)."""
        d, f, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab_size
        emb = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family == "ssm":
            dz = 2 * self.d_inner + 2 * self.ssm_ngroups * self.ssm_state + self.ssm_nheads
            per_layer = d * dz + self.d_inner * d + self.d_inner
        else:
            if self.attn_type == "mla":
                qdim = self.n_heads * self.qk_head_dim
                attn = (
                    (d * self.q_lora_rank + self.q_lora_rank * qdim)
                    + d * (self.kv_lora_rank + self.qk_rope_dim)
                    + self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                    + self.n_heads * self.v_head_dim * d
                )
            else:
                attn = d * self.n_heads * self.d_head + 2 * d * self.n_kv_heads * self.d_head
                attn += self.n_heads * self.d_head * d
            per_layer += attn
            if self.hybrid:
                dz = 2 * self.d_inner + 2 * self.ssm_ngroups * self.ssm_state + self.ssm_nheads
                per_layer += d * dz + self.d_inner * d
        n_moe_layers = 0
        if self.n_experts:
            n_moe_layers = self.n_layers - self.first_k_dense
            dense_layers = self.first_k_dense
        else:
            dense_layers = self.n_layers if self.family != "ssm" else 0
        ffn_dense = 3 * d * f if self.act == "silu" else 2 * d * f
        moe_ffn = self.n_experts * 3 * d * self.moe_d_ff + d * self.n_experts
        moe_ffn += self.n_shared_experts * 3 * d * self.moe_d_ff
        total = emb + L * per_layer + dense_layers * ffn_dense + n_moe_layers * moe_ffn
        if self.n_encoder_layers:
            enc = self.n_encoder_layers * (4 * d * d + ffn_dense)
            total += enc + self.n_layers * 2 * d * d  # cross-attention
        return int(total)

    def active_param_count(self) -> int:
        """Activated parameters per token (MoE: top-k + shared only)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        n_moe_layers = self.n_layers - self.first_k_dense
        all_experts = n_moe_layers * self.n_experts * 3 * d * self.moe_d_ff
        active = n_moe_layers * self.top_k * 3 * d * self.moe_d_ff
        return int(full - all_experts + active)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
