"""Full model: embeddings -> layer groups -> final norm -> logits.

The counterpart of the JAX package's `models/model.py`:
  - `forward(params, cfg, batch)`           prefill; optionally returns the
                                            KV cache for decode;
  - `decode_step(params, cfg, tok, cache)`  one token for every sequence;
  - `loss_fn(params, cfg, batch)`           next-token (or frame-label) CE,
                                            differentiable.
The serving entries run under `torch.inference_mode()`; `loss_fn` runs
the same body with autograd on (`_forward`).  The `first_k_dense` leading
layers (DeepSeek's) are ungrouped ``dense{l}`` entries of the parameter
and cache trees and run first; then the JAX package's `lax.scan` over
layer groups is a Python loop over the stacked leaves' first axis.  The
MoE aux loss is summed as in the JAX package.  Remat: ``"none"`` keeps
every activation, ``"block"`` checkpoints each layer group
(`torch.utils.checkpoint`: the JAX package's `jax.checkpoint` saving
nothing), ``"dots"`` checkpoints each group selectively, saving the
outputs of `aten.mm` and `aten.addmm` and recomputing the rest (the JAX
package's `checkpoint_dots_with_no_batch_dims`: the weight projections
go through `layers.matmul`, which folds (B, S, D) x (D, F) into `mm`;
attention's products have batch axes, lower to `bmm` and are recomputed,
and so is the flash kernel's autograd Function, which is no aten op and
launches its forward again in the backward), and the loss's chunks are
checkpointed as there.  The JAX
package's `_grad_safe_barrier` keeps XLA from hoisting a sharded
all-gather out of its scan; one card gathers nothing, so it has no
counterpart here (an identity).

Inputs (`make_batch_specs` gives their shapes):
  LM        : {"tokens": (B, S) int}
  audio     : {"embeddings": (B, S, F), "labels": (B, S) int}  (hubert)
  vlm       : {"patches": (B, P, F), "tokens": (B, S - P) int} (paligemma)
The audio and vision frontends are stubs, as in the JAX package: frames
and patches arrive as precomputed embeddings, projected into d_model by
``embed/frontend_proj``; the vlm patches come ahead of the text tokens and
attend to each other fully (`cfg.prefix_len`).  Decode steps take tokens.
Mamba and RWKV-6 states live in the decode cache beside the attention
K/V, written in place by each step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import transformer
from repro_torch.models.layers import (apply_norm, embed_specs, matmul,
                                       norm_specs)
from repro_torch.models.params import TensorSpec

__all__ = [
    "param_specs",
    "forward",
    "decode_step",
    "loss_fn",
    "LOSS_CHUNK",
    "make_batch_specs",
    "make_cache_specs",
    "make_batch_axes",
    "make_cache_axes",
    "empty_cache",
    "dtype_of",
    "layer_slice",
    "num_text_tokens",
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
    for l in range(cfg.first_k_dense):
        specs[f"dense{l}"] = transformer.block_specs(cfg, cfg.block_type(l),
                                                     False)
    return specs


def _prefix(cfg: ModelConfig, seq_len: int) -> int:
    """The vlm patches of a sequence of `seq_len`, the JAX package's rule."""
    return min(cfg.prefix_len, seq_len // 2) or seq_len // 2


def make_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """(shape, dtype) of one global batch of this (arch, shape) cell."""
    b, s = shape.global_batch, shape.seq_len
    dt = dtype_of(cfg.dtype)
    fd = cfg.frontend_dim or cfg.d_model
    if cfg.family == "audio":
        return {"embeddings": TensorSpec((b, s, fd), dt),
                "labels": TensorSpec((b, s), torch.int32)}
    if cfg.family == "vlm":
        p = _prefix(cfg, s)
        return {"patches": TensorSpec((b, p, fd), dt),
                "tokens": TensorSpec((b, s - p), torch.int32)}
    return {"tokens": TensorSpec((b, s), torch.int32)}


def num_text_tokens(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Tokens that count in the LM loss (vlm: the text suffix only)."""
    if cfg.family == "vlm":
        return shape.global_batch * (shape.seq_len
                                     - _prefix(cfg, shape.seq_len))
    return shape.global_batch * shape.seq_len


def make_cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """Decode cache tree: one stacked entry per layout position, one
    ``dense{l}`` entry per leading dense layer, and the current length
    ``index``."""
    layout = transformer.layer_layout(cfg)
    dt = dtype_of(cfg.dtype)
    cache: dict = {"groups": {}, "index": TensorSpec((), torch.int64)}
    for p, (bt, _) in enumerate(layout.positions):
        leaf = transformer.block_cache_spec(cfg, bt, batch, max_seq, dt)
        cache["groups"][f"pos{p:02d}"] = {
            key: TensorSpec((layout.num_groups,) + spec.shape, spec.dtype)
            for key, spec in leaf.items()}
    for l in range(cfg.first_k_dense):
        cache[f"dense{l}"] = transformer.block_cache_spec(
            cfg, cfg.block_type(l), batch, max_seq, dt)
    return cache


def make_batch_axes(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Logical axes tree matching `make_batch_specs`."""
    if cfg.family == "audio":
        return {"embeddings": ("batch", "seq", None),
                "labels": ("batch", "seq")}
    if cfg.family == "vlm":
        return {"patches": ("batch", None, None),
                "tokens": ("batch", "seq")}
    return {"tokens": ("batch", "seq")}


def make_cache_axes(cfg: ModelConfig) -> dict:
    """Logical axes tree matching `make_cache_specs`."""
    layout = transformer.layer_layout(cfg)

    def block_axes(bt: str) -> dict:
        if bt == "attn":
            if cfg.use_mla:
                return {"c_kv": ("batch", "seq_kv", "kv_lora"),
                        "k_rope": ("batch", "seq_kv", None)}
            if cfg.cluster_kv:
                return {
                    "centroids": ("batch", "kv_heads", "kv_clusters", None),
                    "k_slots": ("batch", "kv_heads", "kv_clusters", None,
                                None),
                    "v_slots": ("batch", "kv_heads", "kv_clusters", None,
                                None),
                    "slot_valid": ("batch", "kv_heads", "kv_clusters", None),
                    "k_recent": ("batch", None, "kv_heads", None),
                    "v_recent": ("batch", None, "kv_heads", None),
                    "recent_len": (),
                }
            return {"k": ("batch", "seq_kv", "kv_heads", None),
                    "v": ("batch", "seq_kv", "kv_heads", None)}
        if bt == "mamba":
            return {"ssm": ("batch", "mlp", "state"),
                    "conv": ("batch", None, "mlp")}
        return {"wkv": ("batch", "heads", None, None),
                "x_prev_time": ("batch", "embed"),
                "x_prev_chan": ("batch", "embed")}

    axes: dict = {"groups": {}, "index": ()}
    for p, (bt, _) in enumerate(layout.positions):
        axes["groups"][f"pos{p:02d}"] = {
            key: ("layers",) + a for key, a in block_axes(bt).items()}
    for l in range(cfg.first_k_dense):
        axes[f"dense{l}"] = block_axes(cfg.block_type(l))
    return axes


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
    # `F.embedding`: its gradient on the card sums repeated tokens in a
    # fixed order, where indexing's would add them with atomics
    return F.embedding(tokens.long(), params["embed"]["tokens"]).to(
        dtype_of(cfg.dtype))


def _embed_inputs(params: dict, cfg: ModelConfig,
                  batch: dict) -> torch.Tensor:
    """The first hidden states (B, S, d_model) of a batch: audio frames
    projected, vlm patches projected ahead of the text tokens, or
    tokens."""
    dt = dtype_of(cfg.dtype)
    proj = params["embed"].get("frontend_proj")
    if cfg.family == "audio":
        return matmul(batch["embeddings"].to(dt), proj)
    if cfg.family == "vlm":
        patches = matmul(batch["patches"].to(dt), proj)
        return torch.cat([patches, _embed_tokens(params, cfg,
                                                 batch["tokens"])], dim=1)
    return _embed_tokens(params, cfg, batch["tokens"])


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
    each layout position's attention entries stacked over groups, e.g.
    (num_groups, B, S, Hk, hd) k and v, and each ``dense{l}`` layer's
    unstacked; a Mamba or RWKV-6 position's entry is None (its state is
    rebuilt by replay, as in the JAX package).  For vlm, S counts the
    patches and the text."""
    return _forward(params, cfg, batch, return_cache=return_cache)


REMAT = ("none", "block", "dots")
# what remat "dots" saves: the products with no batch axis
DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_contexts():
    return create_selective_checkpoint_contexts(list(DOTS_SAVED))


def _forward(params: dict, cfg: ModelConfig, batch: dict, *,
             return_cache: bool = False, remat: str = "none",
             return_hidden: bool = False):
    """`forward`'s body, under whatever grad mode the caller set.  With
    `return_hidden`, returns (final hidden (B, S, d_model), aux_loss) and
    skips the unembedding; `remat` "block" checkpoints each layer group
    and "dots" each group's products (only where autograd records)."""
    if remat not in REMAT:
        raise ValueError(f"remat {remat!r}: one of {REMAT}")
    layout = transformer.layer_layout(cfg)
    x = _embed_inputs(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    caches: dict = {}
    for l in range(cfg.first_k_dense):
        x, c, aux = transformer.block_forward(
            params[f"dense{l}"], x, cfg, cfg.block_type(l), False,
            positions=positions, return_cache=return_cache)
        aux_total = aux_total + aux
        caches[f"dense{l}"] = c
    per_layer: dict = {f"pos{p:02d}": [] for p in range(layout.period)}
    aux_groups = []

    def group_body(x, g):
        group = layer_slice(params["groups"], g)
        aux_g = torch.zeros((), dtype=torch.float32, device=x.device)
        for p, (bt, moe) in enumerate(layout.positions):
            x, c, aux = transformer.block_forward(
                group[f"pos{p:02d}"], x, cfg, bt, moe, positions=positions,
                return_cache=return_cache)
            aux_g = aux_g + aux
            if return_cache:
                per_layer[f"pos{p:02d}"].append(c)
        return x, aux_g

    remat_on = remat != "none" and torch.is_grad_enabled() and \
        not return_cache
    extra = {"context_fn": _dots_contexts} if remat == "dots" else {}
    for g in range(layout.num_groups):
        if remat_on:
            x, aux_g = checkpoint(group_body, x, g, use_reentrant=False,
                                  **extra)
        else:
            x, aux_g = group_body(x, g)
        aux_groups.append(aux_g)
    aux_total = aux_total + torch.stack(aux_groups).sum()
    if return_cache:
        caches["groups"] = {
            key: None if entries[0] is None else
            {leaf: torch.stack([c[leaf] for c in entries])
             for leaf in entries[0]}
            for key, entries in per_layer.items()}
    x = apply_norm(params["final_norm"], x, cfg)
    if return_hidden:
        return x, aux_total
    return (_logits(params, cfg, x), aux_total,
            caches if return_cache else None)


@torch.inference_mode()
def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                cache: dict):
    """One decode step for every sequence, `tokens` (B,) the newest token
    of each; returns (logits (B, V), cache).  The cache's entries (K/V at
    ``index``, the Mamba and RWKV-6 states) are written in place through
    views of the stacked leaves; the returned tree carries
    ``index + 1``."""
    index = cache["index"]
    x = _embed_tokens(params, cfg, tokens[:, None])
    out: dict = {"index": index + 1}
    for l in range(cfg.first_k_dense):
        key = f"dense{l}"
        x, out[key] = transformer.block_decode(
            params[key], x, cache[key], index, cfg, cfg.block_type(l), False)
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
    out["groups"] = groups
    return logits, out


# ---------------------------------------------------------------------------
# Loss.
# ---------------------------------------------------------------------------

LOSS_CHUNK = 512


def _targets_and_mask(cfg: ModelConfig, batch: dict, seq_len: int) -> tuple:
    """Per-position target ids (int64) and validity mask (f32) aligned with
    the hidden states: position t predicts target[t]; invalid positions
    (vlm prefix patches, the last position of a causal LM) carry target 0
    and mask 0."""
    if cfg.family == "audio":
        labels = batch["labels"].long()
        return labels, torch.ones(labels.shape, dtype=torch.float32,
                                  device=labels.device)
    f32 = torch.float32
    if cfg.family == "vlm":
        text = batch["tokens"].long()
        b = text.shape[0]
        p = seq_len - text.shape[1]
        zeros = lambda n, dt: torch.zeros((b, n), dtype=dt,
                                          device=text.device)
        targets = torch.cat([zeros(p - 1, torch.int64), text,
                             zeros(1, torch.int64)], dim=1)
        mask = torch.cat([zeros(p - 1, f32),
                          torch.ones(text.shape, dtype=f32,
                                     device=text.device),
                          zeros(1, f32)], dim=1)
        return targets, mask
    toks = batch["tokens"].long()
    targets = torch.cat([toks[:, 1:], torch.zeros_like(toks[:, :1])], dim=1)
    ones = torch.ones(toks[:, 1:].shape, dtype=f32, device=toks.device)
    mask = torch.cat([ones, torch.zeros((toks.shape[0], 1), dtype=f32,
                                        device=toks.device)], dim=1)
    return targets, mask


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, *,
            z_loss: float = 1e-4, remat: str = "block"):
    """Mean next-token CE (+ z-loss + MoE aux).  Returns (loss, metrics),
    0-dim f32 tensors, differentiable with respect to `params`.

    The unembedding and the CE run chunked over the sequence (`LOSS_CHUNK`
    positions at a time, each chunk checkpointed), so the (B, S, vocab)
    logits are never all kept for the backward, as in the JAX package.
    """
    hidden, aux = _forward(params, cfg, batch, remat=remat,
                           return_hidden=True)
    b, s, d = hidden.shape
    targets, mask = _targets_and_mask(cfg, batch, s)
    chunk = min(LOSS_CHUNK, s)
    if s % chunk:
        chunk = s  # unchunked for odd lengths, the JAX package's rule

    def chunk_ce(h, t, m):
        logits = _logits(params, cfg, h).to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, t[..., None], dim=-1)[..., 0]
        return ((logz - gold) * m).sum(), (torch.square(logz) * m).sum()

    ce_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    zl_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, s, chunk):
        parts = (hidden[:, lo:lo + chunk], targets[:, lo:lo + chunk],
                 mask[:, lo:lo + chunk])
        if torch.is_grad_enabled():
            c, z = checkpoint(chunk_ce, *parts, use_reentrant=False)
        else:
            c, z = chunk_ce(*parts)
        ce_sum = ce_sum + c
        zl_sum = zl_sum + z
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = ce_sum / denom
    zl = z_loss * zl_sum / denom
    loss = ce + zl + aux
    return loss, {"ce": ce, "z_loss": zl, "aux": aux}
