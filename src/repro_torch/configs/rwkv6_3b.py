"""rwkv6-3b "Finch" [arXiv:2404.05892].

32L d_model=2560, attention-free (RWKV-6 time mix with data-dependent
decay, head dim 64 => 40 wkv heads), channel-mix d_ff=8960, vocab=65536.
Constant-size recurrent state => runs long_500k natively.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    d_ff=8960,
    vocab_size=65536,
    default_block="rwkv6",
    rwkv_head_dim=64,
)
