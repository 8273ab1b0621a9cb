"""Clustered-KV attention: the paper's fast k-means++ as a serving feature.

The counterpart of the JAX package's `models/cluster_attn.py`.  Long-
context decode reads the whole KV cache per token; the clustered cache
replaces the full scan with a two-level lookup whose codebooks come from
this repository's seeder:

  build (per sequence, offline): the keys of every (sequence, KV head)
    are clustered into C centroids by `ClusterPlan.fit` (fast k-means++
    plus a few Lloyd steps; on the card the seeder's tree sweeps are the
    hand-written kernels), and the tokens are laid out cluster by cluster
    in slots of a fixed capacity (padding masked);
  decode (per token): q scores the C centroids, the top `topc` clusters'
    tokens are gathered and attended exactly, together with an exact ring
    of the newest tokens.

A step reads O(C + topc * cap + recent) keys instead of O(S).  Decode is
plain PyTorch, as the JAX package computes it outside any kernel.  The
ring is written in place (`append_recent`), the port's cache convention;
the JAX function returns a copy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.models.params import TensorSpec

__all__ = [
    "ClusterKVConfig",
    "build_clustered_cache",
    "clustered_attention",
    "cluster_cache_specs",
    "append_recent",
]

_NEG_INF = -1.0e30


@dataclasses.dataclass(frozen=True)
class ClusterKVConfig:
    num_clusters: int = 1024
    topc: int = 64                  # clusters gathered per query
    capacity_slack: float = 1.25    # slots per cluster = S/C * slack
    recent_window: int = 512        # exact tail (new tokens appended here)
    lloyd_iters: int = 2
    seeder: str = "fastkmeans++"


def _capacity(seq_len: int, cfg: ClusterKVConfig) -> int:
    cap = int(np.ceil(seq_len / cfg.num_clusters * cfg.capacity_slack))
    return max(8, cap)


def cluster_cache_specs(batch: int, kv_heads: int, head_dim: int,
                        v_dim: int, seq_len: int, cfg: ClusterKVConfig,
                        dtype: torch.dtype) -> dict:
    """(shape, dtype) of one layer's clustered cache leaves."""
    c, cap = cfg.num_clusters, _capacity(seq_len, cfg)
    r = cfg.recent_window
    return {
        "centroids": TensorSpec((batch, kv_heads, c, head_dim), dtype),
        "k_slots": TensorSpec((batch, kv_heads, c, cap, head_dim), dtype),
        "v_slots": TensorSpec((batch, kv_heads, c, cap, v_dim), dtype),
        "slot_valid": TensorSpec((batch, kv_heads, c, cap), torch.bool),
        "k_recent": TensorSpec((batch, r, kv_heads, head_dim), dtype),
        "v_recent": TensorSpec((batch, r, kv_heads, v_dim), dtype),
        "recent_len": TensorSpec((), torch.int64),
    }


def build_clustered_cache(keys, values, cfg: ClusterKVConfig, *,
                          seed: int = 0, info: Optional[dict] = None,
                          engine=None, execution=None) -> dict:
    """One layer's clustered cache from its keys (B, S, Hk, Dh) and values
    (B, S, Hk, Dv), NumPy arrays or tensors on any device.

    Each (sequence b, KV head h) is one seeding problem, fitted by
    ``ClusterPlan(spec, execution).fit`` with ``cfg.seeder`` and
    ``cfg.lloyd_iters`` Lloyd steps at seed ``seed + 131 b + h`` on the
    head's keys in float64; `execution` is an `ExecutionSpec` (the
    default ``ExecutionSpec()``: the device backend on the card).  Tokens
    are assigned to the nearest centroid in float64 on the host (the port's
    `lloyd.assign`: attention keys carry large common offsets, where an f32
    expanded form could flip near ties) and kept in token order up to the
    slot capacity; the rest are dropped from the clustered level.  Pass
    `info={}` to receive ``dropped_frac`` and ``capacity``.

    `engine`, a `ClusterEngine`, pipelines the per-head fits (every host
    prepare is submitted before the first result is read); its results are
    the serial loop's bit for bit.  Returns the cache on the execution's
    device (the engine's, with an engine), in the keys' dtype.
    """
    from repro_torch.core.api import ClusterPlan, ClusterSpec
    from repro_torch.core.lloyd import assign
    from repro_torch.core.plan import ExecutionSpec, resolve_device

    if engine is not None:
        execution = engine.execution
    elif execution is None:
        execution = ExecutionSpec()
    dev = resolve_device(execution.device)
    keys = torch.as_tensor(keys)
    values = torch.as_tensor(values)
    b, s, hk, dh = keys.shape
    dv = values.shape[-1]
    c, cap = cfg.num_clusters, _capacity(s, cfg)
    k_dev, v_dev = keys.to(dev), values.to(dev)
    k_host = keys.detach().cpu()
    centroids = torch.zeros((b, hk, c, dh), dtype=keys.dtype, device=dev)
    k_slots = torch.zeros((b, hk, c, cap, dh), dtype=keys.dtype, device=dev)
    v_slots = torch.zeros((b, hk, c, cap, dv), dtype=values.dtype,
                          device=dev)
    valid = torch.zeros((b, hk, c, cap), dtype=torch.bool, device=dev)
    dropped = 0
    base = ClusterSpec(k=c, seeder=cfg.seeder, lloyd_iters=cfg.lloyd_iters,
                       seed=seed)

    def head_pts(bi, h):
        return k_host[bi, :, h, :].to(torch.float64).numpy()

    def head_spec(bi, h):
        return base.replace(seed=seed + 131 * bi + h)

    inflight = {}
    if engine is not None:
        for bi in range(b):
            for h in range(hk):
                pts = head_pts(bi, h)
                inflight[bi, h] = (
                    engine.submit(pts, cluster=head_spec(bi, h)), pts)
    for bi in range(b):
        for h in range(hk):
            if engine is not None:
                ticket, pts = inflight.pop((bi, h))
                res = ticket.result()
            else:
                pts = head_pts(bi, h)
                res = ClusterPlan(head_spec(bi, h), execution).fit(pts)
            centers = res.centers.cpu().numpy().astype(np.float64)
            centroids[bi, h] = torch.from_numpy(centers).to(
                device=dev, dtype=keys.dtype)
            idx, _ = assign(pts, centers)
            # Cluster ci's members in token order, the first `cap` kept:
            # a stable sort by cluster and each token's rank in its group.
            order = np.argsort(idx, kind="stable")
            grouped = idx[order]
            rank = np.arange(s) - np.searchsorted(grouped, grouped)
            keep = rank < cap
            dropped += int((~keep).sum())
            tok = torch.from_numpy(order[keep]).to(dev)
            ci = torch.from_numpy(grouped[keep]).to(dev)
            ri = torch.from_numpy(rank[keep]).to(dev)
            k_slots[bi, h, ci, ri] = k_dev[bi, tok, h]
            v_slots[bi, h, ci, ri] = v_dev[bi, tok, h]
            valid[bi, h, ci, ri] = True
    if info is not None:
        info["dropped_frac"] = dropped / (b * hk * s)
        info["capacity"] = cap
    r = cfg.recent_window
    return {
        "centroids": centroids,
        "k_slots": k_slots,
        "v_slots": v_slots,
        "slot_valid": valid,
        "k_recent": torch.zeros((b, r, hk, dh), dtype=keys.dtype,
                                device=dev),
        "v_recent": torch.zeros((b, r, hk, dv), dtype=values.dtype,
                                device=dev),
        "recent_len": torch.zeros((), dtype=torch.int64, device=dev),
    }


def clustered_attention(q: torch.Tensor, cache: dict, cfg: ClusterKVConfig,
                        *, scale: float) -> torch.Tensor:
    """Two-level attention of one query per sequence, q (B, H, Dh): the
    top `topc` clusters (exact within) and the recent ring.  Returns
    (B, H, Dv) f32; appending to the ring is the caller's job."""
    b, h, dh = q.shape
    cent = cache["centroids"]
    hk, c = cent.shape[1], cent.shape[2]
    g = h // hk
    cap = cache["k_slots"].shape[3]
    dv = cache["v_slots"].shape[-1]
    qf = q.reshape(b, hk, g, dh).to(torch.float32) * scale

    # Level 1: score the centroids, pick the top clusters per (b, KV head).
    c_scores = torch.einsum("bkgd,bkcd->bkgc", qf, cent.to(torch.float32))
    agg = c_scores.amax(dim=2)                          # (B, Hk, C)
    top_idx = torch.topk(agg, min(cfg.topc, c), dim=-1).indices

    # Level 2: gather those clusters' slots and attend exactly.
    def gather(slots):
        return torch.take_along_dim(slots, top_idx[:, :, :, None, None],
                                    dim=2).to(torch.float32)

    k_sel = gather(cache["k_slots"])                    # (B, Hk, T, cap, Dh)
    v_sel = gather(cache["v_slots"])
    m_sel = torch.take_along_dim(cache["slot_valid"],
                                 top_idx[:, :, :, None], dim=2)
    scores = torch.einsum("bkgd,bktcd->bkgtc", qf, k_sel)
    scores = torch.where(m_sel[:, :, None], scores, _NEG_INF)

    # The recent ring (exact).
    kr = cache["k_recent"].to(torch.float32)            # (B, R, Hk, Dh)
    vr = cache["v_recent"].to(torch.float32)
    r_scores = torch.einsum("bkgd,brkd->bkgr", qf, kr)
    r_valid = torch.arange(kr.shape[1], device=q.device) < \
        cache["recent_len"]
    r_scores = torch.where(r_valid, r_scores, _NEG_INF)

    flat = torch.cat([scores.reshape(b, hk, g, -1), r_scores], dim=-1)
    p = torch.softmax(flat, dim=-1)
    n_cl = scores.shape[3] * cap
    p_cl = p[..., :n_cl].reshape(scores.shape)
    out = torch.einsum("bkgtc,bktcv->bkgv", p_cl, v_sel)
    out = out + torch.einsum("bkgr,brkv->bkgv", p[..., n_cl:], vr)
    return out.reshape(b, h, dv)


def append_recent(cache: dict, k_new: torch.Tensor,
                  v_new: torch.Tensor) -> dict:
    """Write the newest token's K/V, (B, Hk, D) each, into the exact ring
    in place and count it in ``recent_len``; returns the cache."""
    r = cache["k_recent"].shape[1]
    pos = (cache["recent_len"] % r).reshape(1)
    cache["k_recent"].index_copy_(1, pos,
                                  k_new[:, None].to(cache["k_recent"].dtype))
    cache["v_recent"].index_copy_(1, pos,
                                  v_new[:, None].to(cache["v_recent"].dtype))
    cache["recent_len"].add_(1)
    return cache
