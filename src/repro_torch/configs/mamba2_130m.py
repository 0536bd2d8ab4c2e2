"""Mamba-2 130M — SSD (state-space duality). [arXiv:2405.21060]

24L, d_model 768 (attention-free), ssm_state 128, headdim 64, expand 2
(d_inner 1536 -> 24 SSM heads), vocab 50280.  Sub-quadratic: runs long_500k.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "mamba2-130m"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="ssm",
        n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, d_head=0,
        d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_conv=4, ssm_expand=2, ssm_headdim=64,
        ssm_ngroups=1, ssm_chunk=128, tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, d_head=0,
        d_ff=0, vocab_size=512,
        ssm_state=16, ssm_conv=4, ssm_expand=2, ssm_headdim=16,
        ssm_ngroups=1, ssm_chunk=8, tie_embeddings=True,
    )
