"""Architecture registry: ``get_config(arch_id)`` resolves ``--arch`` ids.

The shape tables are copies of the JAX package's `configs/*.py`; nothing
here imports that package.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    SHAPES,
    MeshConfig,
    ModelConfig,
    ShapeConfig,
    TrainConfig,
    reduce_for_smoke,
)

_MODULES = {
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "hubert-xlarge": "hubert_xlarge",
    "rwkv6-3b": "rwkv6_3b",
    "qwen3-32b": "qwen3_32b",
    "yi-9b": "yi_9b",
    "olmo-1b": "olmo_1b",
    "qwen1.5-110b": "qwen1_5_110b",
    "paligemma-3b": "paligemma_3b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def cell_is_supported(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether an (arch x shape) cell runs, and why not if skipped.

    Skips follow the assignment: encoder-only archs have no decode step;
    long_500k needs sub-quadratic attention (run for SSM/hybrid; skipped for
    pure full-attention archs unless cluster-KV is enabled).
    """
    if shape.kind == "decode" and cfg.is_encoder:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and shape.kind == "decode":
        if not cfg.sub_quadratic:
            return False, (
                "full-attention arch: 500k-token decode needs sub-quadratic "
                "attention (enable cluster_kv for the beyond-paper variant)"
            )
    return True, ""


__all__ = [
    "ARCH_IDS",
    "get_config",
    "cell_is_supported",
    "SHAPES",
    "MeshConfig",
    "ModelConfig",
    "ShapeConfig",
    "TrainConfig",
    "reduce_for_smoke",
]
