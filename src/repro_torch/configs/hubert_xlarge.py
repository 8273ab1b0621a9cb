"""hubert-xlarge [arXiv:2106.07447].

48L encoder-only transformer, d_model=1280, 16H, d_ff=5120, vocab=504
(cluster targets).  The conv waveform frontend is a stub per the
assignment: `input_specs` provides precomputed frame embeddings of the conv
feature dimension (512), projected into d_model by `frontend_proj`.
Encoder => bidirectional attention; decode shapes are skipped.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    act="gelu",
    norm="layernorm",
    embedding_inputs=True,
    frontend_dim=512,
)
