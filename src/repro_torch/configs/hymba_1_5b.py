"""Hymba-1.5B — hybrid parallel attention + Mamba heads. [arXiv:2411.13676; hf]

32L, d_model 1600, 25 heads (GQA kv=5), d_ff 5504, vocab 32001, ssm_state 16.
Each layer runs an SWA attention branch and an SSM branch in parallel on the
same normed input and fuses their outputs (mean), per the paper's
fused-parallel-heads design.  Sub-quadratic: runs long_500k.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "hymba-1.5b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="hybrid",
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_head=64,
        d_ff=5504, vocab_size=32001,
        attn_type="swa", window=1024,
        ssm_state=16, ssm_conv=4, ssm_expand=2, ssm_headdim=64,
        ssm_ngroups=1, ssm_chunk=128, rope_theta=1e4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="hybrid",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=512,
        attn_type="swa", window=8,
        ssm_state=16, ssm_headdim=16, ssm_chunk=8, q_chunk=16,
    )
