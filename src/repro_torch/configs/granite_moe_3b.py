"""Granite-3.0 MoE 3B-A800M. [hf:ibm-granite; hf]

32L, d_model 1536, 24 heads (GQA kv=8), 40 experts top-8, d_ff 512/expert,
vocab 49155, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "granite-moe-3b-a800m"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_head=64,
        d_ff=512, vocab_size=49155,
        n_experts=40, top_k=8, moe_d_ff=512,
        tie_embeddings=True, rope_theta=1e4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="moe",
        n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, d_head=16,
        d_ff=64, vocab_size=512,
        n_experts=8, top_k=2, moe_d_ff=64,
        tie_embeddings=True, q_chunk=16,
    )
