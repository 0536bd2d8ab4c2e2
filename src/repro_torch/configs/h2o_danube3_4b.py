"""H2O-Danube3-4B — llama/mistral mix with sliding-window attention.
[arXiv:2401.16818]

24L, d_model 3840, 32 heads (GQA kv=8), d_ff 10240, vocab 32000, SWA.
Sub-quadratic (window 4096): runs long_500k.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "h2o-danube-3-4b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, d_head=120,
        d_ff=10240, vocab_size=32000,
        attn_type="swa", window=4096, rope_theta=1e4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        n_layers=2, d_model=96, n_heads=8, n_kv_heads=2, d_head=12,
        d_ff=192, vocab_size=512,
        attn_type="swa", window=8, q_chunk=16,
    )
