"""Config dataclasses: model architecture and input shapes.

A copy of the JAX package's `configs/base.py` (`ModelConfig`,
`ShapeConfig`, `SHAPES`, `MeshConfig`, `TrainConfig`,
`reduce_for_smoke`), so that the port imports nothing of that package.
Every architecture is a `ModelConfig` instance in its own module under
`repro_torch.configs`; the registry in `__init__.py` resolves ``--arch``
ids.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

__all__ = [
    "ModelConfig",
    "ShapeConfig",
    "SHAPES",
    "TrainConfig",
    "reduce_for_smoke",
]

BlockType = Literal["attn", "mamba", "rwkv6"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int                  # 0 for attention-free archs
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 => d_model // num_heads

    # Attention variants.
    causal: bool = True             # False => encoder (hubert)
    qk_norm: bool = False           # qwen3
    qkv_bias: bool = False          # qwen1.5 / qwen2-moe
    rope_theta: float = 10000.0

    # MLA (deepseek-v2).
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128

    # MoE.
    num_experts: int = 0            # routed experts; 0 => dense MLP
    num_shared_experts: int = 0
    moe_top_k: int = 2
    expert_d_ff: int = 0            # per-expert hidden dim (0 => d_ff)
    capacity_factor: float = 1.25
    router_aux_coeff: float = 0.01
    first_k_dense: int = 0          # leading layers that stay dense (deepseek)
    moe_period: int = 1             # MoE every `period` layers (jamba: 2)
    moe_offset: int = 0

    # Hybrid layout (jamba): one attention layer per `attn_period` layers.
    attn_period: int = 1            # 1 => every layer is `default_block`
    attn_offset: int = 0
    default_block: BlockType = "attn"

    # Mamba (jamba's SSM layers).
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # RWKV-6.
    rwkv_head_dim: int = 64

    # Norm / embeddings / misc.
    norm: str = "rmsnorm"           # rmsnorm | layernorm | layernorm_nonparam
    tie_embeddings: bool = False
    act: str = "silu"               # silu | gelu
    # Modality frontend stub: inputs arrive as precomputed embeddings of this
    # dimension instead of token ids (audio frames / vision patches).
    embedding_inputs: bool = False
    frontend_dim: int = 0           # incoming embedding dim (0 => d_model)
    prefix_len: int = 0             # vlm: prefix tokens with full attention

    # Repeat K/V to the full query-head count inside attention so the score
    # tensors shard over the TP axis even when num_kv_heads < mesh width
    # (GQA's (hk, g) factorisation otherwise leaves attention replicated).
    # §Perf optimisation knob.
    attn_repeat_kv: bool = False

    # Store mamba's per-token scan inputs (dt/B/C) in bf16 instead of f32
    # (math stays f32 inside the step) — halves the dominant activation
    # tensors of SSM layers.  §Perf optimisation knob.
    mamba_lowp_scan: bool = False

    # MoE dispatch strategy: "global" (one sort over all tokens — simple,
    # but SPMD lowers the scatter/gather to full-buffer collectives) or
    # "two_stage" (per-DP-shard dispatch, expert-major reshard — bounded
    # all-to-alls; the §Perf optimisation, ~100x fewer collective bytes).
    moe_dispatch: str = "global"

    # Numerics.
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    # Paper-technique integration (clustered KV cache for long decode).
    cluster_kv: bool = False
    cluster_kv_clusters: int = 1024
    cluster_kv_topc: int = 64       # clusters gathered per query

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.expert_d_ff == 0:
            object.__setattr__(self, "expert_d_ff", self.d_ff)

    # ---- derived --------------------------------------------------------

    @property
    def has_attention(self) -> bool:
        return self.default_block == "attn" or self.attn_period > 1

    @property
    def is_encoder(self) -> bool:
        return not self.causal

    @property
    def sub_quadratic(self) -> bool:
        """Can serve 500k-token contexts without full-attention KV scans."""
        return self.default_block in ("mamba", "rwkv6") or self.cluster_kv

    def block_type(self, layer: int) -> BlockType:
        if self.attn_period > 1:
            return "attn" if layer % self.attn_period == self.attn_offset else self.default_block
        return self.default_block

    def layer_is_moe(self, layer: int) -> bool:
        if self.num_experts == 0 or layer < self.first_k_dense:
            return False
        return layer % self.moe_period == self.moe_offset

    def param_count(self) -> int:
        """Total parameters (embeddings included once if tied)."""
        from repro_torch.models.model import param_specs  # no cycle
        import math

        specs = param_specs(self)
        total = 0

        def walk(node):
            nonlocal total
            if isinstance(node, dict):
                for v in node.values():
                    walk(v)
            else:
                total += math.prod(node.shape)

        walk(specs)
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: shared + top_k experts)."""
        if self.num_experts == 0:
            return self.param_count()
        full = self.param_count()
        # Subtract the non-activated routed experts' weights.
        moe_layers = sum(
            1 for l in range(self.num_layers) if self.layer_is_moe(l)
        )
        per_expert = 3 * self.d_model * self.expert_d_ff
        inactive = moe_layers * (self.num_experts - self.moe_top_k) * per_expert
        return full - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    shape: tuple = (16, 16)
    axes: tuple = ("data", "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    microbatches: int = 1           # gradient accumulation steps
    remat: str = "block"            # none | block (dots: not ported yet)
    grad_compression: str = "none"  # none | int8 | topk (not ported yet)
    z_loss: float = 1e-4
    checkpoint_every: int = 100
    seed: int = 0


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    changes = dict(
        num_layers=min(cfg.num_layers, 4 if cfg.attn_period <= 1 else cfg.attn_period),
        d_model=128,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0,
        head_dim=32 if cfg.num_heads else 0,
        d_ff=256,
        vocab_size=512,
        dtype="float32",
        param_dtype="float32",
    )
    if cfg.num_experts:
        changes.update(num_experts=min(cfg.num_experts, 8), expert_d_ff=64,
                       num_shared_experts=min(cfg.num_shared_experts, 2),
                       moe_top_k=min(cfg.moe_top_k, 2))
    if cfg.use_mla:
        changes.update(kv_lora_rank=64, qk_rope_dim=16, qk_nope_dim=32,
                       v_head_dim=32)
    if cfg.attn_period > 1:
        changes.update(num_layers=2 * cfg.attn_period)
    if cfg.default_block == "mamba":
        changes.update(mamba_d_state=8)
    if cfg.prefix_len:
        changes.update(prefix_len=8)
    if cfg.frontend_dim:
        changes.update(frontend_dim=64)
    return dataclasses.replace(cfg, **changes)
