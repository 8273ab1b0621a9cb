"""deepseek-v2-lite-16b [arXiv:2405.04434].

27L d_model=2048 16H, MLA kv_lora_rank=512 (qk_rope=64, qk_nope=128,
v_head=128), vocab=102400.  MoE: 64 routed top-6 + 2 shared experts of
hidden 1408; first layer stays dense (first_k_dense_replace=1).

Note: the assignment line reads "64e top-6 — 2 shared+160 routed"; the
published DeepSeek-V2-Lite config has 64 routed experts (the 160-expert
router belongs to full V2), so we follow the leading "64e top-6" spec.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    use_mla=True,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    num_experts=64,
    num_shared_experts=2,
    moe_top_k=6,
    expert_d_ff=1408,
    first_k_dense=1,
)
