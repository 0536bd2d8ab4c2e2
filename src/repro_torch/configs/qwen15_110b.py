"""Qwen1.5-110B — dense. [hf:Qwen; hf]

80L, d_model 8192, 64 heads (GQA kv=8), d_ff 49152, vocab 152064, QKV bias.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "qwen1.5-110b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
        d_ff=49152, vocab_size=152064,
        qkv_bias=True, rope_theta=1e6, q_chunk=256,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_head=16,
        d_ff=384, vocab_size=512, qkv_bias=True, q_chunk=16,
    )
