"""MiniCPM-2B — llama-like dense, trained with WSD schedule. [arXiv:2404.06395]

40L, d_model 2304, 36 heads (MHA: kv=36), d_ff 5760, vocab 122753, tied
embeddings.  The WSD (warmup-stable-decay) schedule belongs to the training path,
which the port does not have yet.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "minicpm-2b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, d_head=64,
        d_ff=5760, vocab_size=122753,
        tie_embeddings=True, rope_theta=1e4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        n_layers=2, d_model=96, n_heads=6, n_kv_heads=6, d_head=16,
        d_ff=192, vocab_size=512, tie_embeddings=True, q_chunk=16,
    )
