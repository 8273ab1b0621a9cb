"""Full model: embeddings -> layer groups -> final norm -> logits.

The counterpart of the JAX package's `models/model.py`, for inference:
  - `forward(params, cfg, batch)`           prefill; optionally returns the
                                            KV cache for decode;
  - `decode_step(params, cfg, tok, cache)`  one token for every sequence.
Both run under `torch.inference_mode()`.  The JAX package's `lax.scan`
over layer groups is a Python loop over the stacked leaves' first axis;
its remat policies and barriers belong to training, as does `loss_fn`
(a later slice).  Inputs are token batches, ``{"tokens": (B, S) int}``:
the audio and vlm frontends are not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import transformer
from repro_torch.models.attention import TensorSpec
from repro_torch.models.layers import (apply_norm, embed_specs, matmul,
                                       norm_specs)

__all__ = [
    "param_specs",
    "forward",
    "decode_step",
    "make_batch_specs",
    "make_cache_specs",
    "empty_cache",
    "dtype_of",
    "layer_slice",
]


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name ("bfloat16", "float32")."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def layer_slice(tree: dict, i: int) -> dict:
    """Layer `i` of a tree of stacked leaves (a view of each)."""
    return {key: layer_slice(node, i) if isinstance(node, dict) else node[i]
            for key, node in tree.items()}


# ---------------------------------------------------------------------------
# Specs.
# ---------------------------------------------------------------------------

def param_specs(cfg: ModelConfig) -> dict:
    layout = transformer.layer_layout(cfg)
    specs: dict = {
        "embed": embed_specs(cfg),
        "final_norm": norm_specs(cfg),
        "groups": {},
    }
    for p, (bt, moe) in enumerate(layout.positions):
        specs["groups"][f"pos{p:02d}"] = transformer.stack_specs(
            transformer.block_specs(cfg, bt, moe), layout.num_groups)
    # first_k_dense layers come only with MoE, which block_specs refuses.
    return specs


def make_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """(shape, dtype) of one global batch of this (arch, shape) cell."""
    if cfg.family in ("audio", "vlm"):
        raise NotImplementedError(
            f"{cfg.name}: {cfg.family} inputs are not ported yet: ROADMAP "
            "Queue 1 item 11")
    return {"tokens": TensorSpec((shape.global_batch, shape.seq_len),
                                 torch.int32)}


def make_cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """Decode cache tree: one stacked entry per layout position, plus the
    current length ``index``."""
    layout = transformer.layer_layout(cfg)
    dt = dtype_of(cfg.dtype)
    cache: dict = {"groups": {}, "index": TensorSpec((), torch.int64)}
    for p, (bt, _) in enumerate(layout.positions):
        leaf = transformer.block_cache_spec(cfg, bt, batch, max_seq, dt)
        cache["groups"][f"pos{p:02d}"] = {
            key: TensorSpec((layout.num_groups,) + spec.shape, spec.dtype)
            for key, spec in leaf.items()}
    return cache


def empty_cache(cfg: ModelConfig, batch: int, max_seq: int, device) -> dict:
    """A zero decode cache on `device` (``index`` 0)."""
    def zeros(node):
        if isinstance(node, dict):
            return {key: zeros(v) for key, v in node.items()}
        return torch.zeros(node.shape, dtype=node.dtype, device=device)

    return zeros(make_cache_specs(cfg, batch, max_seq))


# ---------------------------------------------------------------------------
# Embedding & head.
# ---------------------------------------------------------------------------

def _embed_tokens(params: dict, cfg: ModelConfig,
                  tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"]["tokens"][tokens.long()].to(dtype_of(cfg.dtype))


def _logits(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    emb = params["embed"]
    if cfg.tie_embeddings:
        return x @ emb["tokens"].T.to(x.dtype)
    return matmul(x, emb["head"])


# ---------------------------------------------------------------------------
# Forward (prefill) and decode.
# ---------------------------------------------------------------------------

@torch.inference_mode()
def forward(params: dict, cfg: ModelConfig, batch: dict, *,
            return_cache: bool = False):
    """Returns (logits (B, S, V), aux_loss, caches_or_None).  Caches hold
    one (num_groups, B, S, Hk, hd) k and v per layout position."""
    layout = transformer.layer_layout(cfg)
    x = _embed_tokens(params, cfg, batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    per_layer: dict = {f"pos{p:02d}": [] for p in range(layout.period)}
    for g in range(layout.num_groups):
        group = layer_slice(params["groups"], g)
        for p, (bt, moe) in enumerate(layout.positions):
            x, c, aux = transformer.block_forward(
                group[f"pos{p:02d}"], x, cfg, bt, moe, positions=positions,
                return_cache=return_cache)
            aux_total += aux
            if return_cache:
                per_layer[f"pos{p:02d}"].append(c)
    caches = None
    if return_cache:
        caches = {"groups": {
            key: {leaf: torch.stack([c[leaf] for c in entries])
                  for leaf in entries[0]}
            for key, entries in per_layer.items()}}
    x = apply_norm(params["final_norm"], x, cfg)
    return _logits(params, cfg, x), aux_total, caches


@torch.inference_mode()
def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                cache: dict):
    """One decode step for every sequence, `tokens` (B,) the newest token
    of each; returns (logits (B, V), cache).  The cache's K/V are written
    in place; the returned tree carries ``index + 1``."""
    index = cache["index"]
    x = _embed_tokens(params, cfg, tokens[:, None])
    layout = transformer.layer_layout(cfg)
    groups = cache["groups"]
    for g in range(layout.num_groups):
        group = layer_slice(params["groups"], g)
        for p, (bt, moe) in enumerate(layout.positions):
            key = f"pos{p:02d}"
            x, _ = transformer.block_decode(
                group[key], x, layer_slice(groups[key], g), index, cfg, bt,
                moe)
    x = apply_norm(params["final_norm"], x, cfg)
    logits = _logits(params, cfg, x)[:, 0, :]
    return logits, {"index": index + 1, "groups": groups}
