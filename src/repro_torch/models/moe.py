"""Mixture-of-Experts FFN with sort-based capacity dispatch.

The counterpart of the JAX package's `models/moe.py`.  Dispatch is the
JAX package's, step for step, so that the same tokens are kept and dropped:
top-k routing over the physical experts (padded experts masked to -1e30
before the softmax, so never routed to) -> a stable sort of the (token,
expert) assignments by expert -> each assignment's rank in its expert's
group by one `searchsorted` -> a fixed (E, cap, d) buffer, assignments
past the capacity dropped -> the expert GLUs as batched products -> the
weighted combine.  The expert products are plain large matrix products,
which the JAX package leaves to XLA outside any Pallas kernel; here they
are batched `torch.matmul`.

The combine gathers each token's k contributions through the inverse of
the sort and adds them in ascending expert order, the order in which the
JAX package's scatter-add meets them.  It uses no atomics, so the card
gives the same bits on every run.  The port has no model mesh, so the
two-stage dispatch runs with one data-parallel shard, as the JAX package's
does without a mesh.

`kmeans_router_init` seeds router rows with fast k-means++ centroids of
token embeddings (the port's NumPy seeders, the JAX package's draws).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _act, apply_mlp, matmul, mlp_specs
from repro_torch.models.params import ParamSpec

__all__ = ["moe_specs", "apply_moe", "kmeans_router_init", "phys_experts"]


EXPERT_PAD_MULTIPLE = 16  # physical experts padded to the TP mesh width
MOE_CHUNK_TOKENS = 65536  # dispatch window; bounds the buffers' size


def phys_experts(e: int) -> int:
    """Physical expert count: padded up to a multiple of 16 past 16."""
    if e <= EXPERT_PAD_MULTIPLE:
        return e
    m = EXPERT_PAD_MULTIPLE
    return ((e + m - 1) // m) * m


def moe_specs(cfg: ModelConfig) -> dict:
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.expert_d_ff
    ep = phys_experts(e)
    specs = {
        "router": ParamSpec((d, ep), ("embed", None), scale=0.02),
        "wi_gate": ParamSpec((ep, d, ff), ("expert", "embed", "expert_mlp")),
        "wi_up": ParamSpec((ep, d, ff), ("expert", "embed", "expert_mlp")),
        "wo": ParamSpec((ep, ff, d), ("expert", "expert_mlp", "embed")),
    }
    if cfg.num_shared_experts:
        specs["shared"] = mlp_specs(cfg, d_ff=cfg.num_shared_experts * ff)
    return specs


def apply_moe(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """Returns (y (B, S, d), aux_load_balance_loss 0-dim f32).

    Tokens are dispatched in windows of `MOE_CHUNK_TOKENS` (all at once
    when that does not divide them); capacity applies per window and the
    aux loss is the windows' mean, as in the JAX package.
    """
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    chunk = min(MOE_CHUNK_TOKENS, t)
    if t % chunk:
        chunk = t
    ys, aux = [], torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, t, chunk):
        yc, aux_c = _moe_tokens(params, xf[lo: lo + chunk], cfg)
        ys.append(yc)
        aux = aux + aux_c
    y = ys[0] if len(ys) == 1 else torch.cat(ys)
    y = y.reshape(b, s, d)
    if cfg.num_shared_experts:
        y = y + apply_mlp(params["shared"], x, cfg)
    return y, aux / len(ys)


def _moe_tokens(params: dict, xf: torch.Tensor, cfg: ModelConfig):
    """Dispatch, expert GLUs and combine of one (T, d) token window.  The
    JAX package's global dispatch rounds the capacity up to a multiple of
    256 and combines in the tokens' dtype; its two-stage dispatch, here
    with one data-parallel shard (no mesh), rounds to 128 and combines in
    the experts' output type."""
    _, top_ids, weights, aux = route(params, xf, cfg)
    if cfg.moe_dispatch == "two_stage":
        multiple = 128
        dtype = torch.promote_types(xf.dtype, params["wo"].dtype)
    else:
        multiple, dtype = 256, xf.dtype
    cap = _capacity(xf.shape[0], cfg, multiple)
    return _dispatch(params, xf, cfg, top_ids, weights, cap, dtype), aux


def route(params: dict, xf: torch.Tensor, cfg: ModelConfig) -> tuple:
    """Top-k routing of xf (T, d): (probs (T, Ep) f32, top_ids (T, k),
    weights (T, k) f32, aux).  Padded experts get probability 0."""
    t = xf.shape[0]
    e, k = cfg.num_experts, cfg.moe_top_k
    ep = phys_experts(e)
    logits = matmul(xf, params["router"]).to(torch.float32)
    if ep > e:
        pad = torch.arange(ep, device=xf.device) >= e
        logits = torch.where(pad[None, :], -1.0e30, logits)
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_ids = torch.topk(probs, k, dim=-1)
    weights = top_vals / top_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch-style load-balance loss; the counts are exact integers.
    ids = top_ids.reshape(-1)
    density = torch.zeros(ep, dtype=torch.int64, device=xf.device) \
        .scatter_add_(0, ids, torch.ones_like(ids)).to(torch.float32) \
        / (t * k)
    aux = e * torch.sum(density * probs.mean(dim=0)) * cfg.router_aux_coeff
    return probs, top_ids, weights, aux


def _capacity(t: int, cfg: ModelConfig, multiple: int) -> int:
    """Slots per expert: the JAX package's rounding to `multiple`."""
    cap = int(np.ceil(t * cfg.moe_top_k / cfg.num_experts
                      * cfg.capacity_factor))
    return max(8, min(-(-cap // multiple) * multiple if cap > multiple
                      else cap, t))


def _dispatch(params: dict, xf: torch.Tensor, cfg: ModelConfig,
              top_ids: torch.Tensor, weights: torch.Tensor, cap: int,
              dtype: torch.dtype) -> torch.Tensor:
    """The sort-based dispatch, the expert GLUs and the combine of one
    window: (T, d) in `dtype`.  Each kept output is weighted by its
    routing weight cast to `dtype`, and a token's contributions are
    added in `dtype` in ascending expert order."""
    t, d = xf.shape
    k = cfg.moe_top_k
    ep = phys_experts(cfg.num_experts)
    dev = xf.device
    flat_e = top_ids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    st = order // k                          # the token of each assignment
    group_start = torch.searchsorted(se, torch.arange(ep, device=dev))
    rank = torch.arange(t * k, device=dev) - group_start[se]
    keep = rank < cap
    slot = se * cap + rank
    # dropped assignments land in one spare row past the last slot, so no
    # shape depends on the routing
    buf = torch.zeros((ep * cap + 1, d), dtype=xf.dtype, device=dev)
    buf.index_copy_(0, torch.where(keep, slot, ep * cap), xf[st])
    buf = buf[:ep * cap].reshape(ep, cap, d)

    dt = torch.promote_types(xf.dtype, params["wi_gate"].dtype)
    gate = torch.matmul(buf.to(dt), params["wi_gate"].to(dt))
    up = torch.matmul(buf.to(dt), params["wi_up"].to(dt))
    h = _act(gate, cfg.act) * up
    out = torch.matmul(h, params["wo"].to(dt)).reshape(ep * cap, d)

    # contrib[j] is assignment j's (in the sorted order) weighted output,
    # 0 where dropped; inverse[i * k + c] is where token i's choice c went.
    w_sorted = weights.reshape(-1)[order]
    contrib = torch.where(keep[:, None], out[slot.clamp_max(ep * cap - 1)],
                          0.0)
    contrib = contrib * w_sorted[:, None].to(dtype)
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(t * k, device=dev)
    by_expert = torch.argsort(top_ids, dim=-1)
    mine = contrib[torch.gather(inverse.reshape(t, k), 1, by_expert)]
    y = torch.zeros((t, d), dtype=dtype, device=dev)
    for c in range(k):
        y = y + mine[:, c].to(dtype)
    return y


def kmeans_router_init(router, token_embeddings, *,
                       seeder: str = "fastkmeans++", seed: int = 0):
    """Router rows from k-means++ centroids of token embeddings (the
    port's NumPy seeders): unit centroid directions scaled to the router's
    mean magnitude times sqrt(d).  Takes and returns a NumPy array (d, Ep)
    in the router's dtype."""
    from repro_torch.core.seeding import SEEDERS

    router = np.asarray(router)
    d, e = router.shape
    rng = np.random.default_rng(seed)
    result = SEEDERS[seeder](np.asarray(token_embeddings).astype(np.float64),
                             e, rng)
    ctr = result.centers
    ctr = ctr / np.maximum(np.linalg.norm(ctr, axis=1, keepdims=True), 1e-9)
    scale = float(np.abs(router).mean() * np.sqrt(d)) or 0.02
    return (ctr * scale).T.astype(router.dtype)
