"""StarCoder2-7B — dense code model. [arXiv:2402.19173; hf]

32L, d_model 4608, 36 heads (GQA kv=4), d_ff 18432, vocab 49152, LayerNorm +
GELU, RoPE, attention bias.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "starcoder2-7b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, d_head=128,
        d_ff=18432, vocab_size=49152,
        norm="layernorm", act="gelu", qkv_bias=True, rope_theta=1e5,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, d_head=16,
        d_ff=192, vocab_size=512,
        norm="layernorm", act="gelu", qkv_bias=True, q_chunk=16,
    )
