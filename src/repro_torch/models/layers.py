"""Shared layers: norms, rotary embedding, dense MLP, embeddings.

The counterpart of the JAX package's `models/layers.py`.  Norms and RoPE
run in f32 and cast back to the input's type.  Products follow `jnp`'s
type promotion (`matmul`): bf16 activations times f32 weights give f32, as
in the JAX code, where `torch.matmul` would raise on the mixed types.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import ParamSpec

__all__ = [
    "matmul", "einsum",
    "norm_specs", "apply_norm",
    "head_norm_specs", "apply_head_norm",
    "mlp_specs", "apply_mlp",
    "rotary", "apply_rope",
    "embed_specs",
]


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted type of the two, as `jnp` computes it."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`torch.einsum` in the promoted type of the two, as `jnp` does."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


# ---------------------------------------------------------------------------
# Norms.  olmo uses non-parametric LayerNorm (no scale/bias).
# ---------------------------------------------------------------------------

def norm_specs(cfg: ModelConfig) -> dict:
    if cfg.norm == "layernorm_nonparam":
        return {}
    return {"scale": ParamSpec((cfg.d_model,), ("embed",), init="ones")}


def apply_norm(params: dict, x: torch.Tensor, cfg: ModelConfig,
               eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    if cfg.norm.startswith("layernorm"):
        x = x - x.mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    if "scale" in params:
        x = x * params["scale"].to(torch.float32)
    return x.to(dt)


def head_norm_specs(dim: int) -> dict:
    return {"scale": ParamSpec((dim,), (None,), init="ones")}


def apply_head_norm(params: dict, x: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last (head) dim — qwen3's qk_norm."""
    dt = x.dtype
    x = x.to(torch.float32)
    inv = torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * inv * params["scale"].to(torch.float32)).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embedding.
# ---------------------------------------------------------------------------

def rotary(positions: torch.Tensor, dim: int, theta: float) -> tuple:
    """(sin, cos) of shape (..., dim/2) for integer positions."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), exps)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); sin/cos: (..., seq, dim/2)."""
    dt = x.dtype
    x = x.to(torch.float32)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    s = sin[..., None, :]
    c = cos[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)


# ---------------------------------------------------------------------------
# Dense (SwiGLU / GeGLU) MLP.
# ---------------------------------------------------------------------------

def mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None) -> dict:
    ff = d_ff or cfg.d_ff
    return {
        "wi_gate": ParamSpec((cfg.d_model, ff), ("embed", "mlp")),
        "wi_up": ParamSpec((cfg.d_model, ff), ("embed", "mlp")),
        "wo": ParamSpec((ff, cfg.d_model), ("mlp", "embed")),
    }


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    # jax.nn.gelu is the tanh approximation by default
    return F.gelu(x, approximate="tanh") if kind == "gelu" else F.silu(x)


def apply_mlp(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    gate = matmul(x, params["wi_gate"])
    up = matmul(x, params["wi_up"])
    return matmul(_act(gate, cfg.act) * up, params["wo"])


# ---------------------------------------------------------------------------
# Embeddings.
# ---------------------------------------------------------------------------

def embed_specs(cfg: ModelConfig) -> dict:
    """Token embeddings, the untied head, and for embedding inputs (the
    audio frames, the vlm patches) `frontend_proj` into d_model."""
    specs = {}
    if cfg.embedding_inputs:
        fd = cfg.frontend_dim or cfg.d_model
        specs["frontend_proj"] = ParamSpec((fd, cfg.d_model), (None, "embed"))
    specs["tokens"] = ParamSpec((cfg.vocab_size, cfg.d_model),
                                ("vocab", "embed"), scale=0.02)
    if not cfg.tie_embeddings:
        specs["head"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                  ("embed", "vocab"))
    return specs
