"""Attention blocks: GQA/MQA (+qk-norm, +qkv-bias).

The counterpart of the JAX package's `models/attention.py`.  Prefill
attention is the hand-written flash kernel (`ops.attention_bshd`: the CUDA
kernel on the card, the chunked online-softmax scan of the JAX package's
`_flash_attention` on the CPU).  Decode is a single-query attention over
the KV cache in plain PyTorch, as the JAX package computes it outside any
kernel; the new token's K/V are written into the cache in place (JAX
returns an updated copy), so a cache is used once, in order.

MLA (DeepSeek-V2) and the clustered KV cache are not ported yet (ROADMAP
Queue 1 item 11): their entries raise.
"""

from __future__ import annotations

import collections
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (
    apply_head_norm,
    apply_rope,
    head_norm_specs,
    matmul,
    rotary,
)
from repro_torch.models.params import ParamSpec

__all__ = [
    "attn_specs",
    "attn_forward",
    "attn_decode",
    "attn_decode_clustered",
    "init_kv_cache_spec",
    "TensorSpec",
]

_NEG_INF = -1.0e30
KV_CHUNK = 1024


# (shape, dtype) of a cache leaf: the port's `jax.ShapeDtypeStruct`.
TensorSpec = collections.namedtuple("TensorSpec", "shape dtype")


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet: ROADMAP Queue 1 "
                               "item 11")


def attn_specs(cfg: ModelConfig) -> dict:
    if cfg.use_mla:
        raise _not_ported(f"{cfg.name}: MLA attention")
    d, hd = cfg.d_model, cfg.head_dim
    specs = {
        "wq": ParamSpec((d, cfg.num_heads, hd), ("embed", "heads", None)),
        "wk": ParamSpec((d, cfg.num_kv_heads, hd), ("embed", "kv_heads", None)),
        "wv": ParamSpec((d, cfg.num_kv_heads, hd), ("embed", "kv_heads", None)),
        "wo": ParamSpec((cfg.num_heads, hd, d), ("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((cfg.num_heads, hd), ("heads", None),
                                init="zeros")
        specs["bk"] = ParamSpec((cfg.num_kv_heads, hd), ("kv_heads", None),
                                init="zeros")
        specs["bv"] = ParamSpec((cfg.num_kv_heads, hd), ("kv_heads", None),
                                init="zeros")
    if cfg.qk_norm:
        specs["q_norm"] = head_norm_specs(hd)
        specs["k_norm"] = head_norm_specs(hd)
    return specs


def init_kv_cache_spec(cfg: ModelConfig, batch: int, max_seq: int,
                       dtype: torch.dtype) -> dict:
    """Per-layer KV cache leaves (stacked over layers by the caller)."""
    if cfg.use_mla:
        raise _not_ported(f"{cfg.name}: the MLA latent cache")
    shape = (batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return {"k": TensorSpec(shape, dtype), "v": TensorSpec(shape, dtype)}


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhe->bshe", x, w) with `jnp`'s type promotion."""
    d, h, e = w.shape
    return matmul(x, w.reshape(d, h * e)).unflatten(-1, (h, e))


def _unheads(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshe,hed->bsd", out, wo) with `jnp`'s type promotion."""
    h, e, d = wo.shape
    return matmul(out.flatten(-2), wo.reshape(h * e, d))


def _qkv(params: dict, x: torch.Tensor, pos: torch.Tensor,
         cfg: ModelConfig) -> tuple:
    """q (B, S, H, hd) and k, v (B, S, Hk, hd) with bias, qk-norm and RoPE
    at positions `pos` (B or 1, S)."""
    q = _heads(x, params["wq"])
    k = _heads(x, params["wk"])
    v = _heads(x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if cfg.qk_norm:
        q = apply_head_norm(params["q_norm"], q)
        k = apply_head_norm(params["k_norm"], k)
    sin, cos = rotary(pos, cfg.head_dim, cfg.rope_theta)
    return apply_rope(q, sin, cos), apply_rope(k, sin, cos), v


def attn_forward(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                 positions: Optional[torch.Tensor] = None,
                 return_cache: bool = False):
    """(y (B, S, d_model), {"k", "v"} or None) for x (B, S, d_model)."""
    if cfg.use_mla:
        raise _not_ported(f"{cfg.name}: MLA attention")
    b, s, _ = x.shape
    chunk = min(KV_CHUNK, s)
    if s % chunk:
        # the JAX package's `_flash_attention` rule, so that both
        # packages take the same prompts
        raise ValueError(f"sequence length {s} is not a multiple of "
                         f"{chunk}")
    pos = positions if positions is not None else \
        torch.arange(s, device=x.device)[None, :]
    q, k, v = _qkv(params, x, pos, cfg)
    if cfg.attn_repeat_kv and cfg.num_kv_heads < cfg.num_heads:
        g = cfg.num_heads // cfg.num_kv_heads
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    out = ops.attention_bshd(q, k, v, causal=cfg.causal,
                             prefix_len=cfg.prefix_len,
                             scale=1.0 / (cfg.head_dim ** 0.5)).to(x.dtype)
    y = _unheads(out, params["wo"])
    return y, ({"k": k, "v": v} if return_cache else None)


def attn_decode(params: dict, x: torch.Tensor, cache: dict,
                index: torch.Tensor, cfg: ModelConfig):
    """One new token per sequence, x (B, 1, d_model), against the cache.

    Returns (y, cache): the token's K/V are written at `index` (a 0-dim
    integer tensor, the current length) in place, and scores over
    positions past `index` are masked.
    """
    if cfg.use_mla:
        raise _not_ported(f"{cfg.name}: MLA decode")
    b = x.shape[0]
    q, k, v = _qkv(params, x, index.expand(b, 1), cfg)
    ck, cv = cache["k"], cache["v"]
    at = index.reshape(1)
    ck.index_copy_(1, at, k.to(ck.dtype))
    cv.index_copy_(1, at, v.to(cv.dtype))

    s_max = ck.shape[1]
    h, hk = cfg.num_heads, cfg.num_kv_heads
    g = h // hk
    qg = q.reshape(b, hk, g, cfg.head_dim).to(torch.float32)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, ck.to(torch.float32)) / (
        cfg.head_dim ** 0.5)
    valid = torch.arange(s_max, device=x.device)[None, None, None, :] <= index
    scores = torch.where(valid, scores, _NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskv->bkgv", p, cv.to(torch.float32))
    out = out.reshape(b, 1, h, cfg.head_dim).to(x.dtype)
    return _unheads(out, params["wo"]), cache


def attn_decode_clustered(params, x, cache, index, cfg: ModelConfig):
    """Decode against a clustered KV cache (the JAX package's
    `cluster_attn`): not ported yet."""
    raise _not_ported("decode against the clustered KV cache (cluster_kv)")
