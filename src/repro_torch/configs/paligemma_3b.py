"""paligemma-3b [arXiv:2407.07726] — SigLIP + gemma decoder.

Gemma backbone: 18L d_model=2048, 8H MQA (kv=1, head_dim=256),
d_ff=16384, vocab=257216, tied embeddings, GELU.
The SigLIP vision tower is a stub per the assignment: `input_specs`
provides 256 precomputed patch embeddings (width 1152) which
`frontend_proj` maps into d_model; attention is full over the
patch+prompt prefix and causal afterwards (prefix-LM).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    act="gelu",
    tie_embeddings=True,
    embedding_inputs=True,
    frontend_dim=1152,
    prefix_len=256,
)
