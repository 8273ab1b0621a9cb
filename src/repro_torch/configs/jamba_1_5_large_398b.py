"""jamba-1.5-large-398b [arXiv:2403.19887].

72L d_model=8192, hybrid Mamba+attention 1:7 interleave (one attention
layer per period of 8, offset 4), 64H GQA kv=8, d_ff=24576, vocab=65536.
MoE 16 experts top-2 on every other layer (offset 1).
Mamba: d_state=16, d_conv=4, expand=2.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    num_experts=16,
    num_shared_experts=0,
    moe_top_k=2,
    expert_d_ff=24576,
    moe_period=2,
    moe_offset=1,
    attn_period=8,
    attn_offset=4,
    default_block="mamba",
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
)
