"""olmo-1b [arXiv:2402.00838] — non-parametric LayerNorm.

16L d_model=2048, 16H, d_ff=8192 (SwiGLU hidden), vocab=50304, tied
embeddings, norms carry no learned scale/bias.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    norm="layernorm_nonparam",
    tie_embeddings=True,
)
