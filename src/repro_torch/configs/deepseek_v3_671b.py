"""DeepSeek-V3 671B. [arXiv:2412.19437; hf]

61L, d_model 7168, 128 heads, MLA (q_lora 1536, kv_lora 512, qk_nope 128,
qk_rope 64, v_head 128), first 3 layers dense (d_ff 18432), then MoE with
1 shared + 256 routed experts top-8 (d_ff 2048/expert), MTP depth 1,
vocab 129280.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "deepseek-v3-671b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, d_head=128,
        d_ff=18432, vocab_size=129280,
        attn_type="mla",
        q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
        n_experts=256, n_shared_experts=1, top_k=8, moe_d_ff=2048,
        first_k_dense=3, mtp_depth=1, rope_theta=1e4, q_chunk=128,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_head=24,
        d_ff=96, vocab_size=256,
        attn_type="mla",
        q_lora_rank=32, kv_lora_rank=24, qk_nope_dim=16, qk_rope_dim=8,
        v_head_dim=16,
        n_experts=4, n_shared_experts=1, top_k=2, moe_d_ff=32,
        first_k_dense=1, mtp_depth=1, q_chunk=16,
    )
