"""Qwen2-VL-72B — VLM backbone. [arXiv:2409.12191; hf]

80L, d_model 8192, 64 heads (GQA kv=8), d_ff 29568, vocab 152064.
M-RoPE (temporal/height/width sections) + QKV bias.  The vision frontend is a
stub per the assignment: ``input_specs`` supplies precomputed patch
embeddings occupying the sequence prefix.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "qwen2-vl-72b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
        d_ff=29568, vocab_size=152064,
        qkv_bias=True, rope_theta=1e6,
        mrope_sections=(16, 24, 24),  # sums to d_head/2 = 64
        frontend="vision", n_frontend_tokens=1024, q_chunk=256,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_head=16,
        d_ff=256, vocab_size=512,
        qkv_bias=True, rope_theta=1e6, mrope_sections=(2, 3, 3),
        frontend="vision", n_frontend_tokens=8, q_chunk=16,
    )
