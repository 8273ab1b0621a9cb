"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (GQA kv=16) expert_ff=1408 vocab=151936,
MoE: 60 routed top-4 + 4 shared experts (shared hidden = 4*1408 = 5632).
Qwen1.5 lineage => QKV bias.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    qkv_bias=True,
    num_experts=60,
    num_shared_experts=4,
    moe_top_k=4,
    expert_d_ff=1408,
    rope_theta=1_000_000.0,
)
