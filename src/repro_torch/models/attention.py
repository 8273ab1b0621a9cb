"""Attention blocks: GQA/MQA (+qk-norm, +qkv-bias), MLA (DeepSeek-V2) and
decode over the clustered KV cache.

The counterpart of the JAX package's `models/attention.py`.  Prefill
attention is the hand-written flash kernel (`ops.attention_bshd`: the CUDA
kernel on the card, the chunked online-softmax scan of the JAX package's
`_flash_attention` on the CPU); MLA's prefill runs it with q and k of
head dim ``qk_nope_dim + qk_rope_dim`` and v of ``v_head_dim``.  Decode is
a single-query attention over the cache in plain PyTorch, as the JAX
package computes it outside any kernel: GQA over the K/V cache, MLA in
the absorbed-weight form over the latent cache (the per-head K/V are
never materialised), and `attn_decode_clustered` over the codebooks of
`cluster_attn`.  The new token's entries are written into the cache in
place (JAX returns an updated copy), so a cache is used once, in order.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import cluster_attn as CA
from repro_torch.models.layers import (
    apply_head_norm,
    apply_rope,
    einsum,
    head_norm_specs,
    matmul,
    rotary,
)
from repro_torch.models.params import ParamSpec, TensorSpec

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


def attn_specs(cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    if cfg.use_mla:
        rope, nope, vdim = cfg.qk_rope_dim, cfg.qk_nope_dim, cfg.v_head_dim
        r, h = cfg.kv_lora_rank, cfg.num_heads
        return {
            "wq": ParamSpec((d, h, nope + rope), ("embed", "heads", None)),
            "w_dkv": ParamSpec((d, r), ("embed", "kv_lora")),
            "w_kr": ParamSpec((d, rope), ("embed", None)),
            "w_uk": ParamSpec((r, h, nope), ("kv_lora", "heads", None)),
            "w_uv": ParamSpec((r, h, vdim), ("kv_lora", "heads", None)),
            "wo": ParamSpec((h, vdim, d), ("heads", None, "embed")),
            "kv_norm": {"scale": ParamSpec((r,), (None,), init="ones")},
        }
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
        return {
            "c_kv": TensorSpec((batch, max_seq, cfg.kv_lora_rank), dtype),
            "k_rope": TensorSpec((batch, max_seq, cfg.qk_rope_dim), dtype),
        }
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
    """(y (B, S, d_model), cache entries or None) for x (B, S, d_model):
    {"k", "v"}, or MLA's {"c_kv", "k_rope"}."""
    b, s, _ = x.shape
    chunk = min(KV_CHUNK, s)
    if s % chunk:
        # the JAX package's `_flash_attention` rule, so that both
        # packages take the same prompts
        raise ValueError(f"sequence length {s} is not a multiple of "
                         f"{chunk}")
    pos = positions if positions is not None else \
        torch.arange(s, device=x.device)[None, :]
    if cfg.use_mla:
        return _mla_forward(params, x, cfg, pos, return_cache)
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
        return _mla_decode(params, x, cache, index, cfg)
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


def attn_decode_clustered(params: dict, x: torch.Tensor, cache: dict,
                          index: torch.Tensor, cfg: ModelConfig):
    """Decode against a clustered KV cache (`cluster_attn`), GQA only.

    q scores the k-means centroids, the top clusters' tokens are attended
    exactly with the recent ring, and then the token's K/V are appended to
    the ring in place: as in the JAX package, a token does not attend to
    itself in its own step.  Returns (y (B, 1, d_model), cache).
    """
    b = x.shape[0]
    q, k, v = _qkv(params, x, index.expand(b, 1), cfg)
    ckv = CA.ClusterKVConfig(num_clusters=cfg.cluster_kv_clusters,
                             topc=cfg.cluster_kv_topc)
    out = CA.clustered_attention(q[:, 0], cache, ckv,
                                 scale=1.0 / (cfg.head_dim ** 0.5))
    CA.append_recent(cache, k[:, 0], v[:, 0])
    return _unheads(out.to(x.dtype)[:, None], params["wo"]), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): a low-rank latent KV shared by the heads.
# ---------------------------------------------------------------------------

def _rms(x: torch.Tensor, scale: torch.Tensor,
         eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last dim in f32, cast back (the latent's norm)."""
    dt = x.dtype
    x = x.to(torch.float32)
    inv = torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * inv * scale.to(torch.float32)).to(dt)


def _mla_latent(params: dict, x: torch.Tensor, sin, cos) -> tuple:
    """The normed latent c_kv (B, S, R) and the shared roped key k_rope
    (B, S, rope) of x (B, S, d_model)."""
    c_kv = _rms(matmul(x, params["w_dkv"]), params["kv_norm"]["scale"])
    k_rope = matmul(x, params["w_kr"])
    k_rope = apply_rope(k_rope[:, :, None, :], sin, cos)[:, :, 0, :]
    return c_kv, k_rope


def _mla_forward(params: dict, x: torch.Tensor, cfg: ModelConfig,
                 pos: torch.Tensor, return_cache: bool):
    b, s, _ = x.shape
    nope, rope = cfg.qk_nope_dim, cfg.qk_rope_dim
    q = _heads(x, params["wq"])
    sin, cos = rotary(pos, rope, cfg.rope_theta)
    q_rope = apply_rope(q[..., nope:], sin, cos)
    c_kv, k_rope = _mla_latent(params, x, sin, cos)
    k_nope = _heads(c_kv, params["w_uk"])
    v = _heads(c_kv, params["w_uv"])
    k_rope_h = k_rope[:, :, None, :].expand(b, s, cfg.num_heads, rope)
    q_full = torch.cat([q[..., :nope], q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope_h], dim=-1)
    # q, k (B, S, H, nope + rope) and v (B, S, H, v_head_dim): the kernel
    # reads v's narrower head dimension as it is
    out = ops.attention_bshd(q_full, k_full, v, causal=cfg.causal,
                             prefix_len=cfg.prefix_len,
                             scale=1.0 / ((nope + rope) ** 0.5)).to(x.dtype)
    y = _unheads(out, params["wo"])
    return y, ({"c_kv": c_kv, "k_rope": k_rope} if return_cache else None)


def _mla_decode(params: dict, x: torch.Tensor, cache: dict,
                index: torch.Tensor, cfg: ModelConfig):
    """Absorbed-weight MLA decode: q is mapped into the latent space
    (W_uk^T q) and the output comes from the attended latent (W_uv
    absorbed into wo's input), so per-head K/V are never formed.  The
    token's latent and roped key are written at `index` in place."""
    b = x.shape[0]
    nope, rope = cfg.qk_nope_dim, cfg.qk_rope_dim
    q = _heads(x, params["wq"])
    sin, cos = rotary(index.expand(b, 1), rope, cfg.rope_theta)
    q_rope = apply_rope(q[..., nope:], sin, cos)
    c_new, kr_new = _mla_latent(params, x, sin, cos)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    at = index.reshape(1)
    c_kv.index_copy_(1, at, c_new.to(c_kv.dtype))
    k_rope.index_copy_(1, at, kr_new.to(k_rope.dtype))

    f32 = torch.float32
    q_lat = einsum("bshe,rhe->bhr", q[..., :nope],
                    params["w_uk"]).to(f32)
    c32 = c_kv.to(f32)
    scores = torch.einsum("bhr,bsr->bhs", q_lat, c32)
    scores = scores + torch.einsum("bshe,bte->bht", q_rope.to(f32),
                                   k_rope.to(f32))
    scores = scores / ((nope + rope) ** 0.5)
    valid = torch.arange(c_kv.shape[1], device=x.device)[None, None, :] <= \
        index
    p = torch.softmax(torch.where(valid, scores, _NEG_INF), dim=-1)
    lat = torch.einsum("bhs,bsr->bhr", p, c32)
    out = torch.einsum("bhr,rhe->bhe", lat, params["w_uv"].to(f32))
    return _unheads(out.to(x.dtype)[:, None], params["wo"]), cache
