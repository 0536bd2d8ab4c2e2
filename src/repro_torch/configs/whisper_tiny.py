"""Whisper-tiny — encoder-decoder audio backbone. [arXiv:2212.04356]

4L encoder + 4L decoder, d_model 384, 6 heads, d_ff 1536, vocab 51865.
The conv frontend is a stub per the assignment: ``input_specs`` supplies
precomputed frame embeddings (B, 1500, 384).
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "whisper-tiny"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="encdec",
        n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, d_head=64,
        d_ff=1536, vocab_size=51865,
        norm="layernorm", act="gelu", use_rope=False,
        n_encoder_layers=4, encoder_seq=1500, frontend="audio",
        max_decoder_positions=32768,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="encdec",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab_size=512,
        norm="layernorm", act="gelu", use_rope=False,
        n_encoder_layers=2, encoder_seq=32, frontend="audio",
        max_decoder_positions=64, q_chunk=16,
    )
